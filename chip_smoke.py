"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Fourteen paths of the port, each at full width:

  * the compiler's main path (kernel source -> frontend -> VIR ->
    run_pipeline -> CUDA ``simt_launch``): every launch held against the
    plain torch version on the card and the map kernels against a numpy
    reference, and the whole-buffer ``compile_torch`` backend on the card;
  * the VOLT Runtime's top rung, the torch program of
    ``core/backends/torchgen.py`` on the card: the 14 benches it licenses
    at their native shapes through ``interp.launch(torch=True)``, then
    vecadd and psum on the compiler path's inputs (n = 2^24 - 37) and
    transpose, reduce0, sfilter and shuffle_hw at 2^22 lanes with a
    ragged tail through ``Runtime()`` (the card, router on). Each is
    certified against the host's grid executor, then run as the
    certified primary: every such launch must run on the rung on the
    card (a refusal, a demotion, a "fail" verdict or a launch routed to
    the host fails the run), its buffers and ExecStats bit for bit the
    grid executor's, its buffers within the bench's tolerance of a numpy
    reference, the cycle model's cycles equal from both stats, and
    vecadd's and psum's buffers equal to ``simt_launch``'s. Printed per
    bench: certification seconds, the rung's ms (CUDA events, median of
    10 launches), the grid executor's ms on the host, the loop
    iterations that synced with the host, and where the time goes for
    the large launches (a profiler trace); a ``{"runtime": [...]}`` JSON
    line. Past 60 s of the phase the remaining large benches are cut to
    2^20 lanes (printed);
  * the dense LM serving path on granite-3-2b at full width and depth
    (random weights from ``--seed``): ``LM.prefill`` on 4 prompts of 2048
    tokens, whose 81 RMSNorms and 40 attentions go through the rmsnorm
    and flash_attention kernels, and ``ServeEngine`` answering 12
    requests on 8 slots;
  * the MoE LM serving path on olmoe-1b-7b at full width and depth
    (6.9 B params, random weights from ``--seed``, granite's freed
    first): the same prefill, whose 33 RMSNorms, 16 attentions at head
    dim 128 and 16 grouped expert FFs go through the rmsnorm,
    flash_attention and moe_dispatch kernels, and the same engine;
  * the hybrid LM serving path on jamba-1.5-large-398b at full width,
    its depth cut to four layers, one of each kind (mamba with dense FF,
    mamba with MoE FF, attention with dense FF, mamba with MoE FF:
    23.0 B params, random weights from ``--seed``, olmoe's freed first):
    the same prefill, whose 9 RMSNorms at d 8192, one attention (64
    heads, 8 KV heads of 128), 2 grouped expert FFs (16 experts of f
    24576) and 3 x 8 selective scans (one a layer and chunk of 256) go
    through the rmsnorm, flash_attention, moe_dispatch and selective_scan
    kernels, and the same engine. Its kernel checks and timings run
    before its params exist: the plain expert FF holds float32 copies of
    a layer's experts (38.7 GB);
  * the MoE LM serving path on kimi-k2-1t-a32b at full width, its depth
    cut to one layer, its whole period (attention at head dim 112 with
    64 heads and 8 KV heads, 384 experts of d_ff 2048, top-8, and a
    shared FF: 19.4 B params, 38.8 GB, jamba's freed first): the same
    prefill, whose 3 RMSNorms at d 7168, one attention and one grouped
    expert FF at (384, 212, 7168) go through the rmsnorm,
    flash_attention and moe_dispatch kernels, and the same engine, whose
    expert FF at (384, 1, 7168) reads only the experts that hold a
    token. The plain expert FF is held against the kernel on 32 of the
    384 experts at full d and f (all of them in float32 would be 67.6
    GB) and timed over all 384, 32 a call;
  * the recurrent LM serving path on xlstm-1.3b at full width and depth
    (48 layers, an sLSTM and seven mLSTMs a period, d_model 2048, 4 heads
    of 512, no feed-forward: 1.04 B params, random weights from
    ``--seed``, kimi's freed first): the same prefill, whose 49 RMSNorms
    (48 ln1 and ln_f) go through the rmsnorm kernel and whose mixers are
    plain torch (the time in the sLSTM and mLSTM layers printed apart),
    and the same engine; its trace of where the time goes is taken on 4 x
    512 tokens (every mixer's work grows with the tokens, and 4 x 2048
    tokens are 344 K kernels);
  * training granite-3-2b at full width and depth (2.53 B params in bf16,
    AdamW with float32 moments, remat, random weights from ``--seed``,
    xlstm's freed first): ``train_loop`` takes 4 steps of 4 x 2048 tokens,
    whose RMSNorms and attentions go through the rmsnorm and
    flash_attention kernels forward (twice under remat: 161 and 80 a
    step) and through their backward kernels (81 and 40 a step). Printed:
    each step's loss, grad norm and ms, tokens/s after the first step,
    peak memory, the idle share and top kernels of one step, every leaf's
    gradient norm (finite and nonzero). The backward kernels are held
    against their plain versions at the path's shapes (attention also at
    head dims 112 and 128, and at granite's shape with do scaled by 1 /
    8192, as the train step's mean loss scales it), the forward's
    lse-writing launch against the
    launch without lse (its output bit for bit), and two backward calls
    against each other (bit for bit); a depth-2 model at full width takes
    one step on the card and on the CPU from the same params and batch (1
    x 512); and at depth 2, 2 steps, a checkpoint and 2 resumed steps
    repeat 4 straight steps' losses bit for bit. A ``{"train": ...}`` JSON
    line holds the steps' numbers;
  * training olmoe-1b-7b at full width and depth (6.92 B params, AdamW
    with bf16 moments, the reference's own option: float32 ones would
    take the state past the card's 80 GB; remat): first the expert FF's
    backward on the tensor cores (``moe_dispatch_bwd``: three wgmma
    kernels from the forward's saved pre-activation, itself held against
    the plain up product) against its plain version at a layer's shape
    (64, 1280, 2048), f 1024, with a random routing's counts, two calls
    and the Function's gradient bit for bit, and timed beside
    ``torch.autograd.grad`` through the three library calls, and the
    CUDA-core route's ``swiglu_bwd`` kernel alone (float32 and bf16)
    against its plain version and timed; then
    ``train_loop`` takes 4 steps of 4 x 2048 tokens, whose expert FFs go
    through ``moe_dispatch`` forward (twice under remat, keeping the
    pre-activation), ``moe_dispatch_bwd`` and the gather combine
    ``moe_combine`` (the forward, its recompute and the dispatch's
    gradient); tokens/s, step ms, peak memory, idle
    share and top kernels; then at depth 2 a step on the card against the
    CPU (routers zeroed), two MoE layers in float32 with random routers
    card against CPU (ragged counts and capacity drops, the gradients of
    x and of every router, wi and wo; the backward on the CUDA cores,
    ``swiglu_bwd`` counted once a layer), a resume bit for bit and two
    identical steps bit for bit;
  * jamba-1.5-large-398b's gradient at full width cut to two layers
    (``HYBRID_TRAIN_CUT``: a mamba layer with the dense FF, an attention
    layer with the MoE FF, 11.9 B params): first the scan's backward
    (``selective_scan_bwd``, from the forward's saved states, and its dC
    reduce) against its plain version at a chunk (4, 256, 16384, 16)
    float32, two calls and the Function's gradient bit for bit, timed
    beside its byte bound, and the expert FF's backward checked on 2 of
    its 16 experts and timed over all (its plain version 2 experts at a
    time over all); then 3 calls of ``value_and_grad`` (remat, ``loss_chunk``
    512; no AdamW: its moments would add 47.6 GB beside the 47.6 GB of
    params and grads) on 4 x 2048 tokens, each mamba chunk a checkpoint
    region scanned three times and reverse-scanned once; then the smoke
    period's loss on the card against the CPU, and its mamba mixer's
    gradients in float32 (ROADMAP C15 keeps the period's whole gradients
    out). A ``{"train_moe_hybrid": ...}`` JSON line holds both paths'
    steps;
  * the encoder-decoder on seamless-m4t-large-v2 at full width and depth,
    nothing cut (24 encoder and 24 decoder layers, d_model 1024, 16 heads
    of 64, d_ff 8192 with gelu, vocab 256,206: 1.63 B params, random
    weights from ``--seed``, granite's freed first). First the routes it
    puts on the attention kernels, each on the tensor cores against its
    plain version and timed beside ``scaled_dot_product_attention``: the
    forward non-causal at (4, 16, 2048, 64), at 2048 queries against
    1500 keys, at one query row against 2048 keys at 8 slots (and at
    qwen2-vl's head dim 128 against 4096 keys, checked only), the
    backward non-causal at 2048 queries against 1500 keys (do at unit
    scale and at the train step's). Then, each counted: the encoder over
    8 x 2048 frames (49 RMSNorms, 24 non-causal attentions); ``prefill``
    of 4 x 2048 tokens, the decoder alone as the reference's (49, 24);
    ``decode_step`` at 8 slots against the encoder's output (73, and 24
    cross-attentions of one query row; ms, idle share, kernels by name);
    64 teacher-forced decode steps against the decoder's full forward
    over the same tokens and encoder output (held layer by layer at
    XLSTM_LAYER_TOL if the chained logits miss, ROADMAP C15); 4 steps of
    ``build_train_step`` at the reference's train split, 4 x 2048 tokens
    and 4 x 2048 frames (tokens/s after step 0, step ms, peak memory,
    idle share); a step at depth 2 (encoder and decoder) on the card
    against the CPU, 1 x 256 tokens and 128 frames, so that the tokens
    reach the decoder (ROADMAP C16);
  * training qwen2-vl-72b at full width cut to one layer (d_model 8192, 64
    heads of 128 on 8 KV heads, d_ff 29,568, vocab 152,064: 3.37 B
    params; 80 layers are 72 B): 4 steps of ``build_train_step`` with 4 x
    2048 tokens, 256 patch embeddings and M-RoPE positions laid out as
    Qwen2-VL does (the patches at t = 0 on a 16 x 16 grid, the text from
    the grid's largest index on), then its step on the card against the
    CPU on 1 x 64 tokens with 16 patches (the loss and every leaf's
    gradient; AdamW is granite's, held there). A ``{"train_encdec_vlm":
    ...}`` JSON line holds both paths' steps;
  * distribution (``distributed_phase``): ranks as processes sharing the
    one card over gloo, each computing on the card through the kernels
    (gloo's point to point staged through host memory, counted): GPipe,
    granite-3-2b's 40 layers in 4 stages on 4 ranks, 4 microbatches of 1
    x 2048, against one process (``granite-3-2b/gpipe``); the sharded
    train step on (data 2, model 2) at full width cut to 2 layers for
    granite-3-2b and olmoe-1b-7b (32 of 64 experts a rank), the loss,
    every leaf's gradient and the grad norm against the one-process step
    (``granite-3-2b/tp_train``, ``olmoe-1b-7b/tp_train``); the sharded
    decode on (1, 4) with a head-sharded cache and on (1, 3) with a
    sequence-sharded one, against one process (``granite-3-2b/
    tp_decode``); granite's step with the sequence-parallel residual
    against the same step without it, their gradients and collective
    bytes by kind (``granite-3-2b/tp_seqpar``); jamba-1.5-large's step
    on (2, 2) at full width cut to a mamba and an attention layer with
    dense FFs, 2.85 B params, the selective scan and its backward on a
    rank's 4,096 of 16,384 ``d_inner`` channels, its loss, grad norm and
    every leaf's gradient against one process
    (``jamba-1.5-large-398b/tp_train``), and its decode on (1, 4)
    (``.../tp_decode``); xlstm-1.3b's decode and a 1 x 512 prefill on
    (1, 4), one period at full width (``xlstm-1.3b/tp_decode``,
    ``.../tp_prefill``), held within ROADMAP C15's yardstick where bf16
    noise of the random weights passes the atol. A ``{"distributed":
    ...}`` JSON line holds the ranks' ms, peak GB and staged bytes;
    times shared by the ranks on one card are no multi-card times;
  * the port's four examples (``examples/torch_*.py``: the quickstart,
    the SIMT demo, serving with ``--storm`` and ``--launch-storm``, 20
    steps of the ~110 M training example), each on the card in a process
    of its own, all at once; each must exit 0.

On each LM path every kernel is held against its plain version at the
path's shapes, decode is held against prefill, and a short model on the
card against the same model on the CPU (depth 2 at full width for
granite and olmoe; for jamba one period of its smoke config, 8 layers at
d_model 128, and for kimi its smoke config at its published head dim
112, one layer: the only places where widths are cut, since at full
width the CPU would need 46 and 39 GB and minutes). The MoE paths also
print the share of expert assignments the capacity drops (the first MoE
layer, prefill and decode), the tokens routed apart by card and CPU, and
the largest |v| and |h| that the tensor-core routes carry in fp16.
Before the LM paths, both tensor-core routes are held against their
plain versions with one value past fp16's 65504 (ROADMAP C13): attention
at head dims 64, 128 and 112 with one element of v at 7e4, the expert FF
with one row's hidden past the range and with one wo element at 7e4;
each output finite and within the route's tolerance.

Each kernel's launches are counted on each path (counts set to 0 just
before, read just after): a record's ``launches_by_path`` gives each
path's own count (``compiler``; ``<model>/prefill`` and
``<model>/serve``; ``granite-3-2b/train``, ``olmoe-1b-7b/train``,
``jamba-1.5-large-398b/train``; seamless's ``/encode``,
``/prefill``, ``/decode`` and ``/train``; ``qwen2-vl-72b/train``) and ``launches`` their sum
(rmsnorm's record also names xlstm's check, flash_attention's and
moe_dispatch's their past-fp16 checks, ``past_fp16``);
the backward kernels (``rmsnorm_bwd``, ``flash_attention_bwd``,
``moe_dispatch_bwd``, ``selective_scan_bwd``) are counted apart from
the forward ones, and the combine's gather (``moe_combine``, one a MoE
layer at prefill and decode) on its own. flash_attention, moe_dispatch,
flash_attention_bwd and moe_dispatch_bwd also count by route
(``launches_by_route``:
tensor_cores or cuda_cores, on each path); every launch of theirs on the
four prefill paths, the train paths and seamless's paths must take the
tensor cores. flash_attention's and flash_attention_bwd's records hold
the cross routes' rows under ``seamless``.
nvcc's ``-Xptxas -v`` registers and spills of the tensor-core kernels
(and of rmsnorm_bwd's vector route) are printed after the build. Each
kernel is timed, and
the script prints one JSON line of kernel records and a last line
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--seed N] [--reps N]

jamba's one-chip cut: every width as published, the period shortened
from 8 layers to 4 (``n_layers`` 72 -> 4, ``attn_every_k`` 8 -> 4, both
printed). Attention is one layer in four, not one in eight, so it takes
a larger share of prefill than in a deployment. kimi's: ``n_layers`` 61
-> 1 (printed), one whole period; two layers would be 73.0 GB.

It needs a CUDA device and the CUDA toolkit (nvcc), and exits non-zero
without a result when either is missing or any check fails.

Tolerances: integer buffers exact; float buffers exact, except kernels
with EXP or LOG (blackscholes, srad_flag), held at rtol = atol = 1e-5
because CUDA's expf/logf and torch's differ by a few ulps. Against the
numpy reference, blackscholes, srad_flag and psum use the bench's atol
(5e-2, 1e-3 and 1e-3); vecadd, saxpy, cfd_like, vote_hw and bscan_hw are
exact.

LM tolerances, each beside the typical size of what it holds (the
check lines print both):

  * rmsnorm rtol = atol = 1e-5 in float32 and 2e-2 in bf16 (those of
    tests/test_kernels.py); outputs of randn rows and scales have a
    median |y| of about 0.45, one bf16 ulp at most 0.0078 of |y|.
  * flash_attention at the paths' shapes (4, 32, 2048, 64),
    (4, 16, 2048, 128), (4, 64, 2048, 128) and (4, 64, 2048, 112) with 8
    KV heads, causal:
    bf16 rtol 1e-2, atol 2e-3; float32 rtol = atol = 2e-5. With randn q,
    k, v the softmax weights of a row of n keys act as about n / e equal
    ones, so |o| is about (e / n) ** 0.5: a median over all elements of
    about 0.035, up to about 4 in the first rows. The rtol covers one
    bf16 ulp (at most 0.0078 of |o|) and the atol sits well below the
    median |o|, so a dropped or doubled key tile or a wrong scale in a
    late row fails. The plain version rounds one float32 result; the
    bf16 route (tensor cores) also rounds the softmax weights P between
    its two products, to one fp16 part (11 bits, an error up to 2^-11),
    and V to fp16 (exact in fp16's normal range), so its output too is
    within about one ulp of the float32 result. (P in one bf16 part,
    2^-8, misses this tolerance where a few keys carry a row's weight,
    as in the first rows of a causal head.) The cross routes
    (non-causal: every row spreads its weight over all Sk keys, |o| about
    (e / Sk) ** 0.5) are held at the same tolerances.
  * moe_dispatch at (64, 1280, 2048) and (64, 1, 2048), f 1024, at
    (16, 1280, 8192) and (16, 1, 8192), f 24576, and at (384, 212, 7168)
    and (384, 1, 7168), f 2048 (on 32 of the 384 experts), each with
    every slot filled and with the counts of a random routing, bf16:
    rtol 1e-2 (one bf16 ulp of the output), atol 2e-3, well below the
    median |y| printed beside it. The plain version rounds one float32
    result; at C > 1 the bf16 route (tensor cores) also rounds the
    hidden silu(g) * u between its two products, to one fp16 part (11
    bits), and wo to fp16; at C = 1 (CUDA cores) the hidden stays
    float32. (The hidden in one bf16 part misses this tolerance at these
    widths.)
  * selective_scan at (4, 256, 16384, 16), the chunk the path scans:
    float32 rtol = atol = 1e-5 (the same float32 recurrence, the dot
    product summed in another order), bf16 rtol 1e-2 (one bf16 ulp of
    the output), atol 1e-5; the same for a call chained through its
    state h against one call. dA in (0.5, 0.99), dBx and Cm at scale 0.1
    as tests/test_kernels.py draws them: |y| about 0.05.
  * xlstm's decode against its prefill, layer by layer: each of the 48
    layers, fed prefill's input to it, decodes its 64 outputs within
    rtol = atol = 3e-2 (tests/test_torch_ssm.py's BLOCK_TOL; the
    residual stream reaches about 27). Chained through the 48 layers the
    logits are printed, not held: the two paths round bf16 apart by an
    ulp a layer and the random-weight model amplifies it (1.18 apart,
    std 1, on the H100; ROADMAP C15). Its smoke config's one period on
    the card against the CPU: tests/test_archs.py's atol 0.55, rtol 0.1.
  * the past-fp16 checks at the routes' tolerances above (outputs up to
    7e4 for attention, 1e7 for the expert FF, so rtol decides).
  * decode against prefill (64 teacher-forced steps, the path's depth):
    atol 0.2, rtol 0, inside tests/test_archs.py's atol 0.55, rtol 0.1;
    the logits have a standard deviation of about 1 and granite's two
    paths measured 0.098 apart on the H100. olmoe runs both paths at a
    capacity factor of 8, so that neither drops an assignment (at the
    real factor the two paths drop differently by design), and is held
    at test_archs.py's tolerance: bf16 near-ties between the 8th and 9th
    of 64 experts route about one (token, layer) in seven apart on the
    two paths (printed; 149 of 1,024 on the H100, error 0.203).
    jamba (capacity factor 8 too) and kimi (64: C >= T with 384 experts)
    are printed with their random routers (jamba 0.63 apart on the H100:
    a token routed apart moves the logits) and held at atol 0.2, rtol 0
    with their routers zeroed, where both paths route every token
    alike.
  * the depth-2 model on the card against the CPU: atol = rtol = 0.1 on
    the logits (tests/test_torch_lm.py); jamba's 8-layer smoke period and
    kimi's one-layer smoke config at head dim 112, their routers zeroed,
    atol 0.2, rtol 0.1 (tests/test_torch_ssm.py).
  * the backward kernels against their plain versions, as the largest
    |got - want| over the largest |want| of each output (dx, dscale; dq,
    dk, dv): bf16 1e-2 (both round one float32 result to bf16: at most
    one ulp, 2^-7 of the largest value), float32 1e-4 (float32 sums of up
    to 8192 terms in another order); the forward's lse at 1e-5.
  * the depth-2 train step on the card against the CPU: the loss (about
    11.2 at init) at atol 2e-2, each leaf's gradient and each leaf after
    AdamW at relative L2 error 2e-2 (bf16 products summed in another
    order; tests/test_torch_train.py holds the port to jax.grad at the
    same 2e-2). olmoe's with its routers zeroed (bf16 near-ties would
    route tokens apart on the two devices); jamba's smoke period the loss
    alone, its mamba mixer's gradients in float32 at 2e-2.
  * the new backward kernels as the others (bf16 1e-2, float32 1e-4 of
    each output's largest value); the combine's gather against its plain
    version exactly (the same float32 sums in the same order) and against
    ``index_add_`` at rtol = atol = 1e-5 (float32 sums in another
    order).

Each kernel is timed twice: CUDA events around a batch of wrapper calls,
and the device time of its kernel from a torch.profiler trace. A simt
case's record also gives its mode (``warp``: 32-lane workgroups, eight
warps a CTA; ``cta``: one CTA a workgroup, four in turn on a large grid),
the CTAs its main-path launch used (read back from the launcher), the
``__syncthreads`` and ``__syncwarp`` in its source, and for vecadd
``aliased_ms``: the event time with z and x one tensor, where every store
keeps its barrier pair. rmsnorm's record gives decode's 8-row call
(``rows8``: event, device and ``F.rms_norm`` ms) beside each width's 8192
rows.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the allocator grows segments in place instead of caching freed blocks
# whole: the paths' models and their float32 init draws (26 GB for one of
# jamba's expert leaves) follow each other on one card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.convert import to_tensors  # noqa: E402
from repro_torch.core import interp  # noqa: E402
from repro_torch.core import runtime as vrt  # noqa: E402
from repro_torch.core.backends import torchgen  # noqa: E402
from repro_torch.core.backends.torch_backend import compile_torch  # noqa: E402
from repro_torch.core.interp import LaunchParams  # noqa: E402
from repro_torch.core.passes.pipeline import (ABLATION_LADDER,  # noqa: E402
                                              PassConfig, run_pipeline)
from repro_torch.core.simx import CycleModel  # noqa: E402
from repro_torch.core.vir import BINOPS, UNOPS, Op, Ty  # noqa: E402
from repro_torch.kernels.simt_exec import codegen  # noqa: E402
from repro_torch.kernels.simt_exec import simt_exec as sx  # noqa: E402
from repro_torch.kernels.simt_exec.ops import volt_torch_run  # noqa: E402
from repro_torch.volt_bench import suite  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd as fb  # noqa: E402
from repro_torch.kernels.moe_dispatch import moe_combine as mc  # noqa: E402
from repro_torch.kernels.moe_dispatch import moe_dispatch as md  # noqa: E402
from repro_torch.kernels.moe_dispatch import \
    moe_dispatch_bwd as mb  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm as rn  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_bwd as rb  # noqa: E402
from repro_torch.kernels.selective_scan import \
    selective_scan as ss  # noqa: E402
from repro_torch.kernels.selective_scan import \
    selective_scan_bwd as sb  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.blueprint import (count_params, init_params,  # noqa
                                          tree_map)
from repro_torch.models.registry import mrope_grid_positions  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.train.loop import LoopConfig, train_loop  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig,  # noqa: E402
                                         adamw_update, init_opt_state,
                                         leaves)
from repro_torch.train.train_step import (StepConfig,  # noqa: E402
                                          build_train_step, value_and_grad)

N = 2**24 - 37                 # ragged tail: exercises the `gid < n` guard
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
SOURCE = "src/repro_torch/kernels/simt_exec/codegen.py"
REPLACES = "src/repro/kernels/simt_exec/simt_exec.py:121"
CONFIG = PassConfig(uni_hw=True, uni_ann=True, uni_func=True)
EXP_LOG = {"blackscholes", "srad_flag"}


def _inputs(name: str, rng: np.random.Generator, local: int):
    """Full-size buffers, scalars and launch for one bench, drawn as the
    bench's own ``make`` draws them."""
    grid = -(-N // local)
    L = grid * local
    params = LaunchParams(grid=grid, local_size=local, warp_size=32)
    f32 = np.float32
    if name == "vecadd":
        b = {"x": rng.standard_normal(L).astype(f32),
             "y": rng.standard_normal(L).astype(f32),
             "z": np.zeros(L, f32)}
        return b, {"n": N}, params
    if name == "saxpy":
        return {"x": rng.standard_normal(L).astype(f32),
                "y": rng.standard_normal(L).astype(f32)}, \
            {"a": 2.5, "n": N}, params
    if name == "blackscholes":
        return {"S": rng.uniform(10, 100, L).astype(f32),
                "K": rng.uniform(10, 100, L).astype(f32),
                "T": rng.uniform(0.1, 2.0, L).astype(f32),
                "call": np.zeros(L, f32), "put": np.zeros(L, f32)}, \
            {"r": 0.05, "v": 0.3, "n": N}, params
    if name.startswith("srad_flag"):
        return {"img": rng.standard_normal(L).astype(f32),
                "out": np.zeros(L, f32)}, \
            {"lam": 0.5, "mode": int(name[-1]), "n": N}, params
    if name == "cfd_like":
        return {"q": (rng.standard_normal(L) * 1.5).astype(f32),
                "flux": np.zeros(L, f32)}, {"n": N}, params
    if name == "psum":
        return {"x": rng.standard_normal(L).astype(f32),
                "y": np.zeros(L, f32)}, {"n": N}, params
    if name == "vote_hw":
        x = rng.uniform(0, 1.0, L).astype(f32)
        hot = rng.integers(0, grid, grid // 4)
        x[hot * local + 5] = 3.0          # a quarter of the warps vote yes
        return {"x": x, "y": np.zeros(L, f32)}, {"n": N}, params
    if name == "bscan_hw":
        return {"x": rng.standard_normal(L).astype(f32),
                "y": np.zeros(L, np.int32)}, {"n": N}, params
    raise KeyError(name)


def _numpy_ref(name: str, b, sc):
    """Full-size numpy reference for the map kernels and the collectives;
    None where only the plain version holds the kernel."""
    n = sc["n"]
    if name == "vecadd":
        z = b["z"].copy()
        z[:n] = b["x"][:n] + b["y"][:n]
        return {"z": z}, 0.0
    if name == "saxpy":
        y = b["y"].copy()
        y[:n] = np.float32(sc["a"]) * b["x"][:n] + b["y"][:n]
        return {"y": y}, 0.0
    if name == "blackscholes":
        out = suite._ref_blackscholes_np(b, sc)
        return {"call": out["call"], "put": out["put"]}, 5e-2
    if name.startswith("srad_flag"):
        return {"out": suite._ref_srad(b, sc)["out"]}, 1e-3
    if name == "cfd_like":
        v = b["q"][:n]
        f = np.where(v > 0, np.where(v > 1, v * v, v * np.float32(0.5))
                     + np.float32(1),
                     np.where(v < -1, -v * v, v * np.float32(-0.5))
                     - np.float32(1)).astype(np.float32)
        f = np.where(f > 0, np.where(f > 2, f * np.float32(0.25), f) + v, f)
        flux = b["flux"].copy()
        flux[:n] = f
        return {"flux": flux}, 0.0
    if name == "psum":
        xm = np.where(np.arange(b["x"].size) < n, b["x"], np.float32(0))
        y = b["y"].copy()
        y[:n] = np.cumsum(xm.reshape(-1, 32), axis=1).reshape(-1)[:n]
        return {"y": y}, 1e-3
    if name == "vote_hw":
        x = b["x"].reshape(-1, 32)
        gid = np.arange(x.size).reshape(-1, 32)
        hit = ((x > 2.0) & (gid < n)).any(axis=1, keepdims=True)
        y = np.where(hit, x * np.float32(2.0), x).reshape(-1)
        y[n:] = b["y"][n:]
        return {"y": y.astype(np.float32)}, 0.0
    if name == "bscan_hw":
        gid = np.arange(b["x"].size)
        p = ((gid < n) & (b["x"] > 0)).reshape(-1, 32).astype(np.int32)
        ranks = (np.cumsum(p, axis=1) - p).reshape(-1)
        y = b["y"].copy()
        y[:n] = ranks[:n]
        return {"y": y}, 0.0
    return None, None


def _compare(name, got, want, exact_rtol=0.0, exact_atol=0.0):
    """Max abs error over the buffers; raises past the tolerance."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}.{k}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{name}.{k}: non-finite values")
        d = (g.double() - w.double()).abs()
        worst = max(worst, float(d.max()))
        ok = torch.allclose(g.double(), w.double(), rtol=exact_rtol,
                            atol=exact_atol)
        if not ok:
            raise AssertionError(f"{name}.{k}: max abs err {float(d.max())} "
                                 f"past rtol={exact_rtol} atol={exact_atol}")
    return worst


def _median_ms(fn, reps: int, batch: int = 10) -> float:
    """Median over ``reps`` of the CUDA-event time of ``batch`` calls in a
    row, per call (a batch keeps the queue full, so the wrapper's host
    time hides behind the kernels it enqueues)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def _traffic(fn) -> int:
    """Buffers read plus buffers written (each counted once)."""
    reads = {getattr(i.operands[0], "name", "?")
             for i in fn.instructions() if i.op is Op.LOAD}
    writes = {getattr(i.operands[0], "name", "?")
              for i in fn.instructions() if i.op is Op.STORE}
    ptrs = {p.name for p in fn.params if p.ty is Ty.PTR}
    return len(reads & ptrs) + len(writes & ptrs)


ARITH = BINOPS | UNOPS | {Op.SELECT, Op.CMOV}


def _lane_ops(fn, lanes: int) -> int:
    """Lane operations of one pass over the VIR: each arithmetic
    instruction once per lane. Loop trips past the first are left out, so
    this undercounts, as a term of a least time may."""
    return lanes * sum(i.op in ARITH for i in fn.instructions())


def _device_ms(fn, calls: int = 20):
    """Device time per call of the kernels that ``fn`` launches, from a
    torch.profiler trace of ``calls`` calls (CUDA activity only): each
    kernel's mean time over its recorded launches times its launches a
    call, summed over the kernels. The trace can drop launch records (on
    the H100 as many as 1 in 20), so a kernel's launches a call are its
    records a call rounded to a whole number, at least 1 (a name that
    runs twice a call, as two of the expert FF backward's five products
    share a cuBLAS kernel, counts twice). Returns that sum, each
    kernel's ms a call by name, and the records a call. None where the
    trace shows no device time in three tries (one trace of the H100
    came back empty)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.self_device_time_total > 0]
        if evs:
            each: dict = {}
            for e in evs:   # names without the common prefix, cut to 40
                k = e.key.replace("void ", "").replace(
                    "(anonymous namespace)::", "")[:40]
                each[k] = each.get(k, 0.0) + (
                    e.self_device_time_total / e.count / 1e3
                    * max(1, round(e.count / calls)))
            return (sum(each.values()), dict(sorted(each.items())),
                    sum(e.count for e in evs) / calls)
    return None, {}, 0.0


CASES = [("vecadd", 256), ("saxpy", 256), ("blackscholes", 256),
         ("srad_flag0", 256), ("srad_flag1", 256), ("cfd_like", 256),
         ("psum", 32), ("vote_hw", 32), ("bscan_hw", 32)]
#: the case also timed with two buffers sharing storage (the first is the
#: second), which keeps every store's barrier pair: z = x + y written into
#: x moves the same bytes (saxpy has no such pair: x is y reads one
#: buffer, not two)
ALIASED = {"vecadd": ("z", "x")}


# --------------------------------------------------------------------------
# the VOLT Runtime on the card: the torch rung (core/backends/torchgen.py)
# --------------------------------------------------------------------------

#: the benches the torch rung licenses at their native shapes (those the
#: reference's JAX rung licenses)
RT_LICENSED = ("kmeans", "nearn", "pathfinder", "psum", "reduce0",
               "sfilter", "sgemm", "shuffle_hw", "shuffle_sw", "spmv",
               "spmv_csr", "spmv_tail", "transpose", "vecadd")
#: run through Runtime() at a realistic size; vecadd and psum on the
#: compiler path's inputs (n = 2^24 - 37), the rest at RT_LANES
RT_BIG = ("vecadd", "psum", "transpose", "reduce0", "sfilter", "shuffle_hw")
RT_LANES, RT_CUT_LANES = 2**22, 2**20
#: past this many seconds of the phase, the remaining large benches run at
#: RT_CUT_LANES (printed)
RT_BUDGET_S = 60.0
RT_FUEL = 1 << 40
RT_REPS = 10


def _rt_big_case(name, lanes, rng):
    """(buffers, scalars, params, numpy ref of the written buffers, atol)
    for one large Runtime launch: at least ``lanes`` lanes, a ragged tail
    where the bench has one."""
    f32 = np.float32
    if name == "transpose":
        n = math.isqrt(lanes) + 1           # n * n >= lanes, not a multiple
        grid = -(-(n * n) // 32)            # of 32: a ragged tail
        x = rng.standard_normal(n * n).astype(f32)
        b = {"x": x, "y": np.zeros(n * n, f32)}
        return (b, {"n": n}, grid, {"y": x.reshape(n, n).T.reshape(-1)},
                0.0)
    n = lanes + 27
    grid = -(-n // 32)
    L = grid * 32
    x = rng.standard_normal(L).astype(f32)
    xm = np.where(np.arange(L) < n, x, f32(0))
    if name == "reduce0":
        return ({"x": x, "out": np.zeros(grid, f32)}, {"n": n}, grid,
                {"out": xm.reshape(-1, 32).sum(1, dtype=f32)}, 1e-3)
    if name == "shuffle_hw":
        return ({"x": x, "y": np.zeros(grid, f32)}, {"n": n}, grid,
                {"y": xm.reshape(-1, 32).sum(1, dtype=f32)}, 1e-3)
    if name == "sfilter":
        w = np.repeat(rng.uniform(0, 1, grid).astype(f32), 32)
        i = np.arange(L)
        left = np.where(i > 0, np.roll(x, 1), f32(0))
        right = np.where(i < n - 1, np.roll(x, -1), f32(0))
        pick = np.where(w > 0.5, left, right)
        y = np.where(i < n, f32(0.5) * x + f32(0.5) * pick, f32(0))
        return ({"x": x, "y": np.zeros(L, f32), "w": w}, {"n": n}, grid,
                {"y": y.astype(f32)}, 0.0)
    raise KeyError(name)


def _events_ms(fn, reps: int = RT_REPS) -> float:
    """Median CUDA-event time of one call (each call ends in a host sync)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _rt_hold(name, st, bufs, st_grid, grid_bufs, ref, atol):
    """The card's ExecStats and buffers bit-identical to the grid
    executor's, the buffers to the numpy reference within ``atol``, and
    the cycle model's cycles equal from both stats. Returns the max abs
    error against the reference."""
    stats = lambda t: (t.instrs, dict(t.by_op), t.mem_requests,  # noqa
                       t.mem_insts, t.shared_requests, t.atomic_serial,
                       t.max_ipdom_depth)
    if stats(st) != stats(st_grid):
        raise AssertionError(f"runtime {name}: ExecStats {stats(st)} on the "
                             f"card, {stats(st_grid)} from the grid")
    for k, v in grid_bufs.items():
        if bufs[k].tobytes() != v.tobytes():
            raise AssertionError(f"runtime {name}: buffer {k} differs from "
                                 f"the grid executor's")
    for local in (True, False):
        cm = CycleModel(shared_in_local=local)
        if cm.cycles(st) != cm.cycles(st_grid):
            raise AssertionError(f"runtime {name}: cycles differ")
    err = 0.0
    for k, want in ref.items():
        got = bufs[k][:want.size]
        if not np.isfinite(got).all():
            raise AssertionError(f"runtime {name}.{k}: non-finite values")
        d = float(np.abs(got.astype(np.float64) - want).max())
        if not np.allclose(got, want, rtol=0.0, atol=atol):
            raise AssertionError(f"runtime {name}.{k}: max abs err {d} past "
                                 f"atol {atol}")
        err = max(err, d)
    return err


def runtime_phase(dev, seed: int, cases: dict, outs: dict) -> list:
    """The VOLT Runtime with its torch rung on the card. Every launch of
    the phase must run on the rung on the card: a refusal, a demotion, a
    "fail" verdict or a launch the router sends to the host fails it."""
    TT = torchgen.TORCH_TELEMETRY
    records = []
    t_phase = time.perf_counter()

    # (a) every licensed bench at native shape: certify, then the
    # certified primary, through interp.launch(torch=True) (no router)
    for name in RT_LICENSED:
        b = suite.BENCHES[name]
        fn = run_pipeline(b.handle.build(None), b.handle.name,
                          ABLATION_LADDER[-1]).fn
        bufs0, sc, params = b.make(np.random.default_rng(seed))
        grid_bufs = {k: v.copy() for k, v in bufs0.items()}
        t0 = time.perf_counter()
        st_grid = interp.launch(fn, grid_bufs, params, scalar_args=sc)
        grid_ms = (time.perf_counter() - t0) * 1e3
        ok, why = torchgen.licence_check(fn, params, bufs0, sc, {}, dev)
        if not ok:
            raise AssertionError(f"runtime {name}: refused: {why}")
        c0 = dict(TT)
        t0 = time.perf_counter()
        interp.launch(fn, {k: v.copy() for k, v in bufs0.items()}, params,
                      scalar_args=sc, torch=True, device=dev)
        cert_s = time.perf_counter() - t0
        sig = torchgen.shape_sig(fn, params, bufs0, sc, dev)
        verdict = torchgen.recorded(fn, sig)[0]
        bufs = {k: v.copy() for k, v in bufs0.items()}
        syncs0 = TT["host_syncs"]
        st = interp.launch(fn, bufs, params, scalar_args=sc, torch=True,
                           device=dev)
        syncs = TT["host_syncs"] - syncs0
        if (verdict != "pass" or interp.LAST_EXECUTOR[0] != "torch"
                or TT["cert_runs"] - c0["cert_runs"] != 1
                or TT["engaged"] - c0["engaged"] != 1
                or TT["demotions"] != c0["demotions"]):
            raise AssertionError(f"runtime {name}: verdict {verdict}, "
                                 f"executor {interp.LAST_EXECUTOR[0]}, "
                                 f"telemetry {TT} from {c0}")
        ref = {k: v for k, v in b.ref(bufs0, sc).items()
               if k in (b.check_bufs or bufs0)}
        err = _rt_hold(name, st, bufs, st_grid, grid_bufs, ref, b.atol)
        torch_ms = _events_ms(lambda: interp.launch(
            fn, bufs, params, scalar_args=sc, torch=True, device=dev))
        if name in ("nearn", "vecadd"):
            _breakdown(lambda: interp.launch(fn, bufs, params,
                                             scalar_args=sc, torch=True,
                                             device=dev),
                       torch_ms, f"runtime {name} native")
        print(f"runtime {name:11s} native grid {params.grid} x "
              f"{params.local_size}: verdict {verdict}, certification "
              f"{cert_s:.3f} s, torch rung {torch_ms:.3f} ms (events, "
              f"median of {RT_REPS}), grid executor {grid_ms:.3f} ms (host), "
              f"{syncs} loop syncs a launch, max abs err {err:.3g} "
              f"(atol {b.atol}), exact to the grid executor")
        records.append({"bench": name, "size": "native",
                        "lanes": params.grid * params.wg_threads,
                        "verdict": verdict, "cert_s": cert_s,
                        "torch_ms": torch_ms, "grid_ms": grid_ms,
                        "host_syncs": syncs, "max_abs_err": err})

    # (b) realistic sizes through Runtime() on the card, router on
    rt = vrt.Runtime()
    if not (rt.torch and rt.device.type == "cuda"):
        raise AssertionError("Runtime() is not on the card's torch rung")
    lanes = RT_LANES
    for name in RT_BIG:
        rng = np.random.default_rng(seed + 1)
        if name in ("vecadd", "psum"):
            _, bufs0, sc, p0, ck = cases[name]
            fn, grid, block = ck.fn, p0.grid, p0.local_size
            ref, atol = _numpy_ref(name, bufs0, sc)
        else:
            if time.perf_counter() - t_phase > RT_BUDGET_S \
                    and lanes != RT_CUT_LANES:
                lanes = RT_CUT_LANES
                print(f"runtime phase: past {RT_BUDGET_S:.0f} s, the "
                      f"remaining benches cut to {lanes} lanes")
            bufs0, sc, grid, ref, atol = _rt_big_case(name, lanes, rng)
            b = suite.BENCHES[name]
            fn = run_pipeline(b.handle.build(None), b.handle.name,
                              ABLATION_LADDER[-1]).fn
            block = 32
        params = LaunchParams(grid=grid, local_size=block, warp_size=32,
                              fuel=RT_FUEL)
        bufs = {k: v.copy() for k, v in bufs0.items()}
        c0 = dict(TT)
        t0 = time.perf_counter()
        st_grid = rt.launch(fn, grid=grid, block=block, scalar_args=sc,
                            buffers=bufs, fuel=RT_FUEL)
        cert_s = time.perf_counter() - t0
        cert_exec = rt.last_report.executor
        sig = torchgen.shape_sig(fn, params, bufs0, sc, dev)
        verdict, _, grid_ms = torchgen.recorded(fn, sig)
        grid_bufs = {k: v.copy() for k, v in bufs.items()}
        syncs0 = TT["host_syncs"]
        st = rt.launch(fn, grid=grid, block=block, scalar_args=sc,
                       buffers=bufs, fuel=RT_FUEL)
        syncs = TT["host_syncs"] - syncs0
        report = rt.last_report
        if (verdict != "pass" or report.executor != "torch"
                or report.demotions
                or TT["cert_runs"] - c0["cert_runs"] != 1
                or TT["engaged"] - c0["engaged"] != 1
                or TT["routed_small"] != c0["routed_small"]):
            raise AssertionError(f"runtime {name}: verdict {verdict}, "
                                 f"{report.summary()}, telemetry {TT} from "
                                 f"{c0}")
        err = _rt_hold(name, st, bufs, st_grid, grid_bufs, ref, atol)
        simt = ""
        if name in outs:
            # the same launch through the ported simt_exec kernel
            for k, v in outs[name].items():
                if v.cpu().numpy().tobytes() != bufs[k].tobytes():
                    raise AssertionError(f"runtime {name}: buffer {k} "
                                         f"differs from simt_launch's")
            simt = ", equal to simt_launch's"
        torch_ms = _events_ms(lambda: interp.launch(
            fn, bufs, params, scalar_args=sc, torch=True, device=dev))
        wall = report.wall_ms
        _breakdown(lambda: interp.launch(fn, bufs, params, scalar_args=sc,
                                         torch=True, device=dev),
                   torch_ms, f"runtime {name}")
        L = grid * block
        print(f"runtime {name:11s} Runtime() {L} lanes (n {sc['n']}): "
              f"certification {cert_s:.3f} s (executor {cert_exec}; grid "
              f"executor {grid_ms:.1f} ms in it), torch rung {torch_ms:.3f} "
              f"ms (events, median of {RT_REPS}), Runtime.launch "
              f"{wall:.3f} ms, {syncs} loop syncs a launch, routed_small "
              f"{TT['routed_small'] - c0['routed_small']}, max abs err "
              f"{err:.3g} (atol {atol}), exact to the grid executor{simt}")
        records.append({"bench": name, "size": "runtime", "lanes": L,
                        "n": sc["n"], "verdict": verdict, "cert_s": cert_s,
                        "torch_ms": torch_ms, "grid_ms": grid_ms,
                        "runtime_launch_ms": wall, "host_syncs": syncs,
                        "routed_small": 0, "max_abs_err": err})
    return records


# --------------------------------------------------------------------------
# the LM serving paths: granite-3-2b and olmoe-1b-7b at full width and depth
# --------------------------------------------------------------------------

LM_ARCH, MOE_ARCH, HYBRID_ARCH, KIMI_ARCH, XLSTM_ARCH = (
    "granite-3-2b", "olmoe-1b-7b", "jamba-1.5-large-398b", "kimi-k2-1t-a32b",
    "xlstm-1.3b")
#: jamba on one card: every width, one layer of each kind
HYBRID_CUT = {"n_layers": 4, "attn_every_k": 4}
#: kimi-k2 on one card: every width, one period (one attention / MoE layer)
KIMI_CUT = {"n_layers": 1}
#: kimi-k2's expert FF is held against its plain version on this many of
#: its 384 experts (all 384 in float32 would be 67.6 GB)
KIMI_CHECK_EXPERTS = 32
PREFILL_B, PREFILL_S = 4, 2048       # 8192 rows for each RMSNorm
#: the engine's requests: 12 on 8 slots, so that 4 slots are reused (the
#: engine is host-bound: 12 rather than 16 keep the whole script near 10
#: minutes)
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_REQUESTS, SERVE_NEW = 8, 512, 12, 16
RMS_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
FA_TOL = {torch.bfloat16: (1e-2, 2e-3), torch.float32: (2e-5, 2e-5)}
MOE_TOL = (1e-2, 2e-3)               # rtol, atol; bf16
SCAN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-5)}
SMOKE_TOL = (0.1, 0.2)               # rtol, atol; jamba's, kimi's smoke
DECODE_ATOL = 0.2
ROUTED_APART_TOL = (0.1, 0.55)       # rtol, atol of tests/test_archs.py
DECODE_T = 64                        # teacher-forced decode-vs-prefill
KERNELS = {"simt_exec": sx, "rmsnorm": rn, "flash_attention": fa,
           "moe_dispatch": md, "selective_scan": ss, "rmsnorm_bwd": rb,
           "flash_attention_bwd": fb, "moe_combine": mc,
           "moe_dispatch_bwd": mb,
           "selective_scan_bwd": sb}
LM_SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/rmsnorm.py:23"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:113"),
    "moe_dispatch": (
        "src/repro_torch/kernels/moe_dispatch/csrc/moe_dispatch.cu",
        "src/repro/kernels/moe_dispatch/moe_dispatch.py:38"),
    "selective_scan": (
        "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
        "src/repro/kernels/selective_scan/selective_scan.py:59"),
    # the backward kernels have no TPU counterpart: the reference
    # differentiates plain jnp with jax.grad
    "rmsnorm_bwd": (
        "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu",
        "none: jax.grad of src/repro/models/layers.py:28 (rmsnorm)"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention_bwd.cu",
        "none: jax.grad of src/repro/models/layers.py:148 "
        "(attention_chunked)"),
    # the gather combine replaces the reference's scatter-add, not a
    # Pallas kernel
    "moe_combine": (
        "src/repro_torch/kernels/moe_dispatch/csrc/moe_combine.cu",
        "none: the scatter-add combine of src/repro/models/moe.py:91 "
        "(and the gradient of its gather, :81)"),
    "moe_dispatch_bwd": (
        "src/repro_torch/kernels/moe_dispatch/csrc/moe_dispatch_bwd.cu",
        "none: jax.grad of src/repro/models/moe.py:83-86 (the expert "
        "FF's einsums)"),
    "selective_scan_bwd": (
        "src/repro_torch/kernels/selective_scan/csrc/selective_scan_bwd.cu",
        "none: jax.grad of src/repro/models/ssm.py:84-97 "
        "(mamba_scan_chunked's chunk scan)")}


def _count(cfg, mixer=None, ff=None) -> int:
    """Layers of the model with this mixer (or this feed-forward)."""
    period = cfg.layer_pattern()
    return cfg.n_layers // len(period) * sum(
        k.mixer == mixer or k.ff == ff for k in period)


#: launches of the two-route kernels by route, on each counted path
ROUTE_COUNTS: dict = {}
ROUTED = {"flash_attention": fa, "moe_dispatch": md,
          "flash_attention_bwd": fb, "moe_dispatch_bwd": mb}


def _zero_counts() -> None:
    for m in KERNELS.values():
        m.LAUNCHES = 0
    for m in ROUTED.values():
        m.LAUNCHES_BY_ROUTE.update(dict.fromkeys(m.LAUNCHES_BY_ROUTE, 0))


def _counts() -> dict:
    return {k: m.LAUNCHES for k, m in KERNELS.items()}


def _route_counts() -> dict:
    return {k: dict(m.LAUNCHES_BY_ROUTE) for k, m in ROUTED.items()}


#: the kernels whose registers and spills the build log is read for: the
#: tensor-core kernels, decode's expert FF (bf16, one row a CTA) and the
#: rmsnorm backward's vector route at one vector a thread (four CTAs an
#: SM need at most 64 registers)
PTXAS_NAMES = ((r"fa_tc_kernelILi(\d+)E", "fa_tc_kernel<{}>"),
               (r"moe_up_tcE", "moe_up_tc"), (r"moe_down_tcE", "moe_down_tc"),
               (r"moe_down_scaledE", "moe_down_scaled"),
               (r"moe_ff_partialI13__nv_bfloat16Li1E",
                "moe_ff_partial<bf16, 1>"),
               (r"fa_bwd_dkdv_tcILi(\d+)E", "fa_bwd_dkdv_tc<{}>"),
               (r"fa_bwd_dq_tcILi(\d+)E", "fa_bwd_dq_tc<{}>"),
               (r"rmsnorm_bwd_vecI13__nv_bfloat16Li1E",
                "rmsnorm_bwd_vec<bf16, 1>"),
               (r"moe_dh_tcE", "moe_dh_tc"), (r"moe_dx_tcE", "moe_dx_tc"),
               (r"moe_dw_tcE", "moe_dw_tc"),
               (r"scan_bwd_kernelILi16E", "scan_bwd_kernel<16>"))


def _ptxas_lines(kernel) -> list:
    """Registers and spills of each entry of PTXAS_NAMES in the kernel's
    nvcc log (built with -Xptxas=-v)."""
    out, name, spill = [], None, ""
    for line in kernel.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = None
            for pat, label in PTXAS_NAMES:
                k = re.search(pat, m.group(1))
                if k:
                    name = label.format(*k.groups())
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            out.append(f"{name}: {line.split('Used ')[1].strip()}; {spill}")
            name = None
    return out


def _rms_inputs(g, dev, N, d, dtype):
    return (torch.randn(N, d, generator=g, device=dev).to(dtype),
            torch.randn(d, generator=g, device=dev).to(dtype))


def _library_rmsnorm(x, s):
    """The yardstick: torch's own RMSNorm of the same rows."""
    return F.rms_norm(x, (x.shape[1],), s, 1e-6)


def _library_moe(x, wi, wo):
    """The yardstick, three calls in bf16: bmm, silu times mul, bmm."""
    f = wo.shape[1]
    h = torch.bmm(x, wi)
    return torch.bmm(F.silu(h[..., :f]) * h[..., f:], wo)


def _qkv(g, dev, cfg, B, S, dtype):
    """q, k, v as the layer hands them to the kernel: (B, H, S, D) views
    of (B, S, H, D) projections, K/V with the config's KV heads."""
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return tuple(torch.randn(B, S, h, D, generator=g, device=dev)
                 .to(dtype).transpose(1, 2) for h in (H, Hkv, Hkv))


def _fa_checks(g, dev, cfg, errs):
    S = PREFILL_S
    for dt, (rtol, atol) in FA_TOL.items():
        q, k, v = _qkv(g, dev, cfg, PREFILL_B, S, dt)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        e = _compare(f"flash_attention({S}, {cfg.head_dim})",
                     {"o": fa.flash_attention(q, k, v, causal=True)},
                     {"o": want}, rtol, atol)
        errs[("flash_attention", cfg.head_dim, dt)] = e
        print(f"check flash_attention ({PREFILL_B}, {cfg.n_heads}, {S}, "
              f"{cfg.head_dim}) kv heads {cfg.n_kv_heads} causal "
              f"{str(dt)[6:]} vs plain max abs err {e:.3g} (rtol {rtol}, "
              f"atol {atol}; median |o| "
              f"{float(want.float().abs().median()):.3g})")
        del q, k, v, want


def lm_kernel_checks(dev, cfg, seed):
    """Each kernel against its plain version on the card, at the dense
    path's shapes; returns the max abs errors by (kernel, shape, dtype)."""
    g = torch.Generator(dev).manual_seed(seed)
    errs = {}
    _rms_checks(g, dev, cfg, errs)
    _fa_checks(g, dev, cfg, errs)
    return errs


def _rms_checks(g, dev, cfg, errs):
    for N in (PREFILL_B * PREFILL_S, SERVE_SLOTS):
        for dt, tol in RMS_TOL.items():
            x, s = _rms_inputs(g, dev, N, cfg.d_model, dt)
            want = rn.rmsnorm_plain(x, s)
            e = _compare(f"rmsnorm({N})", {"y": rn.rmsnorm(x, s)},
                         {"y": want}, tol, tol)
            errs[("rmsnorm", N, dt)] = e
            print(f"check rmsnorm ({N}, {cfg.d_model}) {str(dt)[6:]} vs "
                  f"plain max abs err {e:.3g} (tol {tol}; median |y| "
                  f"{float(want.float().abs().median()):.3g})")


def _moe_shapes(cfg):
    """The expert FF's capacity at the prefill and the engine's decode."""
    return {n: MOE.capacity(T, cfg.moe_top_k, cfg.moe_experts,
                            cfg.moe_capacity)
            for n, T in (("prefill", PREFILL_B * PREFILL_S),
                         ("decode", SERVE_SLOTS))}


def _sim_counts(g, dev, cfg, T, C):
    """Filled slots of each expert when T tokens each choose top_k of the
    experts at random: min(assigned, C), what models/moe.py hands the
    kernel."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    idx = torch.rand(T, E, generator=g, device=dev).topk(k, dim=1).indices
    assigned = torch.zeros(E, device=dev).index_add_(
        0, idx.reshape(-1), torch.ones(T * k, device=dev))
    return assigned.clamp_max(C).int()


def _max_hidden(x, wi, counts=None) -> float:
    """The largest |silu(x wi_g) * (x wi_u)| over the filled rows, in
    float32, a few experts at a time (at most 4 GB of float32 weights)."""
    E, C, _ = x.shape
    f = wi.shape[2] // 2
    step = max(1, int(2**32 // (wi[0].numel() * 4)))
    worst = 0.0
    for a in range(0, E, step):
        xs = x[a:a + step].float()
        if counts is not None:
            xs = xs * (torch.arange(C, device=x.device)[None, :]
                       < counts[a:a + step, None])[..., None]
        h = torch.bmm(xs, wi[a:a + step].float())
        worst = max(worst, float((F.silu(h[..., :f]) * h[..., f:])
                                 .abs().max()))
    return worst


def _moe_checks(g, dev, cfg, wi, wo, errs, experts=None):
    """The expert FF against its plain version at the path's capacities
    (x drawn as the unit-RMS output of an RMSNorm), with every slot filled
    and with the counts of a random routing (x's rows past them not
    zero); on the first ``experts`` experts only, where given, at full d
    and f. Prints the largest |h| beside fp16's 65504."""
    rtol, atol = MOE_TOL
    E = cfg.moe_experts if experts is None else experts
    wi, wo = wi[:E], wo[:E]
    for name, C in _moe_shapes(cfg).items():
        T = PREFILL_B * PREFILL_S if name == "prefill" else SERVE_SLOTS
        counts = _sim_counts(g, dev, cfg, T, C)[:E].contiguous()
        x = torch.randn(E, C, cfg.d_model, generator=g,
                        device=dev).bfloat16()
        for label, cn in (("every slot", None), ("counts", counts)):
            want = md.grouped_expert_ff_plain(x, wi, wo, cn)
            got = md.grouped_expert_ff(x, wi, wo, cn)
            e = _compare(f"moe_dispatch({C}, {label})", {"y": got},
                         {"y": want}, rtol, atol)
            errs[("moe_dispatch", name, torch.bfloat16)] = max(
                e, errs.get(("moe_dispatch", name, torch.bfloat16), 0.0))
            filled = ("" if cn is None else
                      f", {int((cn > 0).sum())} experts filled, "
                      f"{int(cn.sum())} rows")
            print(f"check moe_dispatch ({E}, {C}, {cfg.d_model}) f "
                  f"{cfg.moe_d_ff} bf16 {label}{filled} vs plain max abs "
                  f"err {e:.3g} (rtol {rtol}, atol {atol}; median |y| "
                  f"{float(want.float().abs().median()):.3g})"
                  + ("" if experts is None else
                     f"; on {E} of {cfg.moe_experts} experts"))
            del want, got
        print(f"moe_dispatch ({E}, {C}, {cfg.d_model}) largest |h| "
              f"{_max_hidden(x, wi):.4g} (fp16 holds up to 65504)")
        del x


def moe_kernel_checks(dev, cfg, layer0, seed):
    """flash_attention at olmoe's head dim and the expert FF at the
    path's capacities (layer 0's weights), each against its plain
    version."""
    g = torch.Generator(dev).manual_seed(seed)
    errs = {}
    _fa_checks(g, dev, cfg, errs)
    _moe_checks(g, dev, cfg, layer0["wi"], layer0["wo"], errs)
    return errs


#: one value past fp16's 65504 (bf16 holds it: ROADMAP C13)
PAST_FP16 = 7e4


def fp16_range_checks(dev, seed) -> dict:
    """ROADMAP C13 on the card: both tensor-core routes with one value
    past fp16's range, each held against its plain version at its
    tolerance (finite, as _compare requires): attention at granite's,
    olmoe's and kimi's head dims (64, 128, 112; 1 x 1024 tokens, the
    paths' heads), causal and not, one element of v at 7e4 and ten
    query rows of each head of that KV head aimed at its key; the expert
    FF at (8, 512, 2048), f 1024 (olmoe's widths, 8 experts), one row's
    hidden past the range (an expert's gate and up columns set to 5
    times that row of x) and one wo element at 7e4. Returns the max abs
    errors by case."""
    g = torch.Generator(dev).manual_seed(seed)
    out = {"flash_attention": {}, "moe_dispatch": {}}
    rtol, atol = FA_TOL[torch.bfloat16]
    for arch in (LM_ARCH, MOE_ARCH, KIMI_ARCH):
        cfg = get_config(arch)
        q, k, v = _qkv(g, dev, cfg, 1, 1024, torch.bfloat16)
        group = cfg.n_heads // cfg.n_kv_heads
        v[0, 1, 700, 5] = PAST_FP16
        q[0, group:2 * group, 800:810] = 4 * k[0, 1, 700]
        for causal in (True, False):
            tc = fa.LAUNCHES_BY_ROUTE["tensor_cores"]
            got = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if fa.LAUNCHES_BY_ROUTE["tensor_cores"] != tc + 1:
                raise AssertionError("past-fp16 attention left the tensor "
                                     "cores")
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            name = f"d{cfg.head_dim}{'_causal' if causal else ''}"
            e = _compare(f"flash_attention past fp16 {name}", {"o": got},
                         {"o": want}, rtol, atol)
            out["flash_attention"][name] = e
            print(f"check flash_attention (1, {cfg.n_heads}, 1024, "
                  f"{cfg.head_dim}) kv heads {cfg.n_kv_heads} causal "
                  f"{causal}, one v at {PAST_FP16:g}: tensor cores vs plain "
                  f"max abs err {e:.3g} (rtol {rtol}, atol {atol}; largest "
                  f"|o| {float(want.float().abs().max()):.4g}, finite)")
        del q, k, v, got, want
    rtol, atol = MOE_TOL
    E, C, d, f = 8, 512, 2048, 1024
    for what in ("h", "wo"):
        x = torch.randn(E, C, d, generator=g, device=dev).bfloat16()
        wi = (torch.randn(E, d, 2 * f, generator=g, device=dev)
              * d ** -0.5).bfloat16()
        wo = (torch.randn(E, f, d, generator=g, device=dev)
              * f ** -0.5).bfloat16()
        if what == "h":
            wi[1, :, 150] = (5 * x[1, 3].float()).bfloat16()
            wi[1, :, f + 150] = wi[1, :, 150]
        else:
            wo[2, 37, 100] = PAST_FP16
        tc = md.LAUNCHES_BY_ROUTE["tensor_cores"]
        got = md.grouped_expert_ff(x, wi, wo)
        torch.cuda.synchronize()
        if md.LAUNCHES_BY_ROUTE["tensor_cores"] != tc + 1:
            raise AssertionError("past-fp16 expert FF left the tensor cores")
        want = md.grouped_expert_ff_plain(x, wi, wo)
        e = _compare(f"moe_dispatch past fp16 {what}", {"y": got},
                     {"y": want}, rtol, atol)
        out["moe_dispatch"][what] = e
        print(f"check moe_dispatch ({E}, {C}, {d}) f {f}, "
              + ("one row's |h| " f"{_max_hidden(x, wi):.4g}" if what == "h"
                 else f"one wo at {PAST_FP16:g}")
              + f": tensor cores vs plain max abs err {e:.3g} (rtol {rtol}, "
              f"atol {atol}; largest |y| {float(want.float().abs().max()):.4g}"
              ", finite)")
        del x, wi, wo, got, want
    return out


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _kernel_row(name, shape, fn, plain_fn, lib_fn, nbytes, ops, ops_rate,
                reps, launches, batch=10, calls=20):
    """Times one kernel at one shape: events (``reps`` batches of
    ``batch`` calls), profiler device time (``calls`` calls), the plain
    version, the library call where there is one (``lib_fn`` None: no
    single torch call computes the function); the bound from bytes and
    ops. The card's SM clock and power draw are read right after the
    events, while it is still loaded."""
    ms = _median_ms(fn, reps, batch)
    clocks = _smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    dev_ms, by_kernel, per_call = _device_ms(fn, calls)
    plain_ms = _median_ms(plain_fn, reps, batch=1)
    library_ms = None if lib_fn is None else _median_ms(lib_fn, reps, batch)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_rate * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"time {name:15s} {shape}  launches {launches}  {ms:.4f} ms  "
          "device " + ("not measured" if dev_ms is None else
                       f"{dev_ms:.4f} ms ({per_call:g} records/call)")
          + f"  bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B, "
          f"{ops:.4g} ops)  share {bound_ms / ms:.3f}  plain "
          f"{plain_ms:.4f} ms  library "
          + ("none" if library_ms is None else f"{library_ms:.4f} ms")
          + f"  card after the events: {clocks.splitlines()[0]} (sm, max "
          "sm, power, temp)")
    if len(by_kernel) > 1:
        print(f"device {name} by kernel: " + "; ".join(
            f"{k} {v:.4f} ms" for k, v in by_kernel.items()))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "device_ms": dev_ms, "device_ms_by_kernel": by_kernel}


def _fa_row(g, dev, cfg, reps, errs):
    B, S, H, D = PREFILL_B, PREFILL_S, cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(g, dev, cfg, B, S, torch.bfloat16)
    nbytes = sum(t.numel() * 2 for t in (q, k, v, q))
    pairs = S * (S + 1) // 2          # (query, key) pairs under the mask
    row = _kernel_row(
        "flash_attention", f"({B}, {H}, {S}, {D}) causal bf16",
        lambda: fa.flash_attention(q, k, v, causal=True),
        lambda: fa.flash_attention_plain(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True),
        nbytes, 4 * B * H * D * pairs, BF16_OPS_PER_S, reps,
        f"{_count(cfg, 'attn')} a prefill")
    return {**row, "max_abs_err": errs[("flash_attention", D,
                                        torch.bfloat16)]}


def lm_kernel_times(dev, cfg, reps, errs):
    """Timing rows at the dense path's shapes; the records take the
    prefill shape in bf16."""
    g = torch.Generator(dev).manual_seed(7)
    d = cfg.d_model
    records = {}
    for N in (PREFILL_B * PREFILL_S, SERVE_SLOTS):
        # four input sets in turn (134 MB at 8192 rows), so that a call
        # does not find its 33.5 MB input in the 50 MB L2 cache
        sets = itertools.cycle([_rms_inputs(g, dev, N, d, torch.bfloat16)
                                for _ in range(4)])
        row = _kernel_row(
            "rmsnorm", f"({N}, {d}) bf16",
            lambda: rn.rmsnorm(*next(sets)),
            lambda: rn.rmsnorm_plain(*next(sets)),
            lambda: _library_rmsnorm(*next(sets)),
            2 * N * d * 2 + d * 2, 4 * N * d, F32_OPS_PER_S, reps,
            f"{2 * cfg.n_layers + 1} a prefill or decode step")
        if N == PREFILL_B * PREFILL_S:
            records["rmsnorm"] = {**row, "max_abs_err":
                                  errs[("rmsnorm", N, torch.bfloat16)]}
        else:   # decode's rows: the events measure the host's time
            records["rmsnorm"][f"rows{N}"] = {
                k: row[k] for k in ("ms", "device_ms", "library_ms")}
    records["flash_attention"] = _fa_row(g, dev, cfg, reps, errs)
    return records


def _moe_rows(dev, cfg, wi, wo, reps, errs, launches, prefill_batch=10,
              plain_experts=None):
    """Timing rows of the expert FF (one layer's weights: far past the L2
    cache): at prefill with every slot filled; at decode
    with the counts of a random routing of the engine's 8 tokens, as the
    path runs it, and once more with every slot filled. The bound: 6 FLOP
    a filled row and (d, f) pair of bf16 products, or the filled rows of
    x, the weights of the experts that hold a row and all of y moved once.
    ``plain_experts``: the plain version runs that many experts a call,
    in turn over all of them (its float32 weights would not fit at once).
    Returns the prefill row with the decode row in it."""
    g = torch.Generator(dev).manual_seed(8)
    E, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    step = E if plain_experts is None else plain_experts
    rows = {}
    for name, C in _moe_shapes(cfg).items():
        x = torch.randn(E, C, d, generator=g, device=dev).bfloat16()
        counts = (_sim_counts(g, dev, cfg, SERVE_SLOTS, C)
                  if name == "decode" else None)
        n_live = E if counts is None else int((counts > 0).sum())
        n_rows = E * C if counts is None else int(counts.sum())
        nbytes = 2 * (n_live * 3 * d * f + n_rows * d + E * C * d)
        batch = prefill_batch if name == "prefill" else 10

        def plain():
            return [md.grouped_expert_ff_plain(
                x[a:a + step], wi[a:a + step], wo[a:a + step],
                None if counts is None else counts[a:a + step])
                for a in range(0, E, step)]

        filled = ("every slot" if counts is None else
                  f"{n_live} of {E} experts filled, {n_rows} rows")
        rows[name] = {**_kernel_row(
            "moe_dispatch", f"({E}, {C}, {d}) f {f} bf16 ({name}, {filled})",
            lambda: md.grouped_expert_ff(x, wi, wo, counts),
            plain, lambda: _library_moe(x, wi, wo),
            nbytes, 6 * n_rows * d * f, BF16_OPS_PER_S, reps, launches,
            batch=batch, calls=2 * batch), "shape": [E, C, d, f],
            "experts_filled": n_live,
            "max_abs_err": errs[("moe_dispatch", name, torch.bfloat16)]}
        if counts is not None:
            rows[name]["ms_every_slot"] = _median_ms(
                lambda: md.grouped_expert_ff(x, wi, wo), reps, batch)
            print(f"time moe_dispatch ({E}, {C}, {d}) every expert read "
                  f"(no counts): {rows[name]['ms_every_slot']:.4f} ms")
        else:   # as training runs it: the pre-activation kept too
            gu = torch.empty(E, C, 2 * f, dtype=torch.bfloat16, device=dev)
            rows[name]["ms_with_gu"] = _median_ms(
                lambda: md.grouped_expert_ff(x, wi, wo, None, gu), reps,
                batch)
            print(f"time moe_dispatch ({E}, {C}, {d}) keeping gu (the "
                  f"backward's pre-activation, {gu.numel() * 2} B): "
                  f"{rows[name]['ms_with_gu']:.4f} ms against "
                  f"{rows[name]['ms']:.4f} ms without")
            del gu
        del x
    print("library for moe_dispatch: three calls in bf16 (bmm, silu times "
          "mul, bmm), every slot" + ("" if step == E else
                                     f"; plain version {step} experts a "
                                     f"call over all {E}"))
    return {**rows["prefill"], "decode": rows["decode"],
            "library": "torch.bmm, F.silu * mul, torch.bmm (bf16)"}


def _combine_row(dev, cfg, reps, launches):
    """The MoE combine's gather at the prefill's shape (4 x 2048 tokens,
    top_k gate ranks, E * C slots of the expert FF's output scaled by
    their weights, float32), from the dispatch of a random routing:
    against its plain version (bit for bit: the same float32 sums in the
    same order) and against the scatter-add it replaces, ``index_add_``
    over the dispatch table (the library yardstick, float32 rounding
    apart). The bound: the kept slots' rows read, the output written and
    the slots read once."""
    g = torch.Generator(dev).manual_seed(12)
    T, k, E = PREFILL_B * PREFILL_S, cfg.moe_top_k, cfg.moe_experts
    d, C = cfg.d_model, _moe_shapes(cfg)["prefill"]
    probs = torch.rand(T, E, generator=g, device=dev).softmax(-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    table, wtable, slots = MOE.dispatch(idx[:, :k], vals[:, :k], T,
                                              E, C)
    yw = torch.randn(E * C, d, generator=g, device=dev) * wtable[:, None]
    got = mc.gather_sum(yw, slots)
    want = mc.gather_sum_plain(yw, slots)
    err = _compare("moe_combine", {"y": got}, {"y": want}, 0.0, 0.0)
    lib = torch.zeros(T + 1, d, device=dev).index_add_(0, table, yw)[:T]
    e_lib = _compare("moe_combine vs index_add_", {"y": got}, {"y": lib},
                     1e-5, 1e-5)
    kept = int((slots < E * C).sum())
    print(f"check moe_combine ({T} tokens, {k} ranks, {E * C} slots, d "
          f"{d}) float32, {kept} of {T * k} assignments kept: vs plain max "
          f"abs err {err:.3g} (exact); vs index_add_ {e_lib:.3g} (rtol = "
          "atol = 1e-5: float32 sums in another order)")
    row = _kernel_row(
        "moe_combine", f"({T}, {k}) of ({E * C}, {d}) float32",
        lambda: mc.gather_sum(yw, slots),
        lambda: mc.gather_sum_plain(yw, slots),
        lambda: torch.zeros(T + 1, d, device=dev).index_add_(0, table, yw),
        4 * (kept * d + T * d + T * k), kept * d, F32_OPS_PER_S, reps,
        launches)
    print("library for moe_combine: torch.zeros(T + 1, d).index_add_(0, "
          "table, yw), the scatter-add models/moe.py ran before")
    return {**row, "max_abs_err": err, "max_abs_err_vs_index_add": e_lib,
            "shape": [T, k, E * C, d], "kept": kept,
            "library": "Tensor.index_add_ (float32)"}


def moe_kernel_times(dev, cfg, layer0, reps, errs):
    """Timing rows of the expert FF (layer 0's weights: 805 MB) and of
    attention at head dim 128."""
    record = _moe_rows(dev, cfg, layer0["wi"], layer0["wo"], reps, errs,
                       f"{cfg.n_layers} a prefill or decode step")
    g = torch.Generator(dev).manual_seed(9)
    return record, _fa_row(g, dev, cfg, reps, errs)


def _breakdown(fn, wall_ms: float, label: str) -> None:
    """Where one call's time goes: the device's busy time (the sum of its
    kernels in a torch.profiler trace of CUDA activity) against the
    call's wall time measured without the profiler, and the kernels that
    take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    if not evs:
        print(f"where the time goes, {label}: not measured (empty trace)")
        return
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    n = sum(e.count for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:5]
    print(f"where the time goes, {label}: wall {wall_ms:.2f} ms, device "
          f"busy {busy:.2f} ms in {n} kernels, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}; top: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top))


def _sync_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _routed(fn):
    """``fn()`` and the expert indices (T, k) of every MoE layer it ran,
    in order."""
    seen, route = [], MOE.route

    def record(p, xt, top_k):
        out = route(p, xt, top_k)
        seen.append(out[2])
        return out

    MOE.route = record
    try:
        return fn(), seen
    finally:
        MOE.route = route


def _apart(a, b) -> int:
    """Tokens whose expert sets differ between two (T, k) routings."""
    return int((a.sort(dim=1).values.cpu()
                != b.sort(dim=1).values.cpu()).any(dim=1).sum())


def _first_moe_dropped(fn, cfg) -> float:
    """The share of expert assignments dropped by capacity at the first
    MoE layer that ``fn()`` runs, from that layer's own input."""
    seen, moe_ff = [], MOE.moe_ff

    def record(p, x, **kw):
        seen.append((p, x))
        return moe_ff(p, x, **kw)

    MOE.moe_ff = record
    try:
        fn()
    finally:
        MOE.moe_ff = moe_ff
    p, x = seen[0]
    return MOE.dropped_share(p, x, n_experts=cfg.moe_experts,
                             top_k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity)


def _no_drop_capacity(cfg) -> float:
    """The capacity factor at which prefill of DECODE_T tokens drops no
    assignment (C >= T): T / (T k // E). 8 for olmoe and jamba, 64 for
    kimi-k2."""
    return DECODE_T / max(1, DECODE_T * cfg.moe_top_k // cfg.moe_experts)


def _fp16_ranges(fn) -> tuple:
    """The largest |v| handed to flash_attention and the largest |h| of
    the expert FFs (filled rows) while ``fn()`` runs: the values the
    tensor-core routes carry in fp16, whose largest is 65504."""
    from repro_torch.models import layers as LAYERS
    seen_v, seen_h = [0.0], [0.0]
    attn, ff = LAYERS.flash_attention, md.grouped_expert_ff

    def attn_rec(q, k, v, **kw):
        seen_v[0] = max(seen_v[0], float(v.abs().max()))
        return attn(q, k, v, **kw)

    def ff_rec(x, wi, wo, counts=None, **kw):
        seen_h[0] = max(seen_h[0], _max_hidden(x, wi, counts))
        return ff(x, wi, wo, counts, **kw)

    LAYERS.flash_attention, md.grouped_expert_ff = attn_rec, ff_rec
    try:
        fn()
    finally:
        LAYERS.flash_attention, md.grouped_expert_ff = attn, ff
    return seen_v[0], seen_h[0]


def _init(dev, cfg, seed):
    model = get_model(cfg)
    bp = model.blueprint()
    params, secs = _sync_s(lambda: init_params(
        bp, torch.Generator(dev).manual_seed(seed)))
    moe = (f", {cfg.moe_experts} experts of d_ff {cfg.moe_d_ff}, top-"
           f"{cfg.moe_top_k}, capacity factor {cfg.moe_capacity}"
           if cfg.moe_experts else "")
    mamba = (f", mamba d_inner {cfg.ssm_d_inner} d_state "
             f"{cfg.ssm_d_state} conv {cfg.ssm_d_conv} chunk {cfg.ssm_chunk}"
             if cfg.family == "hybrid" else "")
    layers = " ".join(f"{k.mixer}/{k.ff}" for k in model.period)
    print(f"lm {cfg.name}: {count_params(bp)} params, {cfg.n_layers} "
          f"layers (period {layers}), d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads ({cfg.n_kv_heads} kv) x {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}{moe}{mamba}, vocab {cfg.vocab}; init on the "
          f"card {secs:.2f} s")
    return model, params


def serve_path(dev, cfg, model, params, seed, prefill_reps=3,
               trace_S=PREFILL_S):
    """The path, counted (counts set to 0 just before each part, read
    just after): one prefill of 4 x 2048 tokens, then the engine
    answering SERVE_REQUESTS requests; then prefill and decode speed, and
    where their time goes. Returns the tokens, the engine, the rng, the counts by
    path and the decode step's inputs."""
    L, arch = cfg.n_layers, cfg.name
    moe_layers = _count(cfg, ff="moe")
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                         generator=torch.Generator(dev).manual_seed(seed),
                         device=dev)
    _zero_counts()
    logits, first_s = _sync_s(lambda: model.prefill(params, toks))
    per_prefill = _counts()
    routes = _route_counts()
    for name, by_route in routes.items():
        if by_route != {"tensor_cores": per_prefill[name], "cuda_cores": 0}:
            raise AssertionError(f"{arch} prefill: {name} launched "
                                 f"{by_route} by route; every launch must "
                                 "take the tensor cores")
    ROUTE_COUNTS[f"{arch}/prefill"] = routes
    want = {"simt_exec": 0, "rmsnorm": 2 * L + 1 - _count(cfg, ff="none"),
            "flash_attention": _count(cfg, "attn"),
            "moe_dispatch": moe_layers,
            "selective_scan": _count(cfg, "mamba") * math.ceil(
                PREFILL_S / cfg.ssm_chunk),
            "rmsnorm_bwd": 0, "flash_attention_bwd": 0,
            "moe_combine": moe_layers, "moe_dispatch_bwd": 0,
            "selective_scan_bwd": 0}
    if per_prefill != want:
        raise AssertionError(f"{arch} prefill launched {per_prefill}; "
                             f"expected {want}")
    if (logits.shape != (PREFILL_B, cfg.padded_vocab)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    print(f"{arch} prefill main path: launches per call {per_prefill}, by "
          f"route {routes}; first call {first_s:.3f} s")

    rng = np.random.default_rng(seed)
    eng = ServeEngine(model, params, slots=SERVE_SLOTS,
                      max_seq=SERVE_MAX_SEQ)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(16, 65))).astype(np.int32),
        max_new=SERVE_NEW) for i in range(SERVE_REQUESTS)]
    for r in reqs:
        eng.submit(r)
    _zero_counts()
    _, serve_s = _sync_s(eng.run_until_drained)
    per_serve = _counts()
    ROUTE_COUNTS[f"{arch}/serve"] = _route_counts()
    bad = [(r.rid, r.error, len(r.out)) for r in reqs
           if not r.done or r.error or len(r.out) != SERVE_NEW]
    if (bad or per_serve["rmsnorm"] < 1 or per_serve["simt_exec"]
            or per_serve["flash_attention"] or per_serve["selective_scan"]
            or per_serve["rmsnorm_bwd"] or per_serve["flash_attention_bwd"]
            or per_serve["moe_dispatch_bwd"]
            or per_serve["selective_scan_bwd"]
            or (per_serve["moe_dispatch"] < 1) != (moe_layers == 0)
            or per_serve["moe_combine"] != per_serve["moe_dispatch"]):
        raise AssertionError(f"serving: failed requests {bad}, launches "
                             f"{per_serve}")
    prompt_toks = sum(len(r.prompt) for r in reqs)
    gen = SERVE_REQUESTS * SERVE_NEW
    print(f"{arch} serve main path: {SERVE_REQUESTS} requests "
          f"({prompt_toks} prompt tokens, {gen} generated) on "
          f"{SERVE_SLOTS} slots in {serve_s:.3f} s, {gen / serve_s:.1f} "
          f"generated tokens/s; launches {per_serve}, by route "
          f"{ROUTE_COUNTS[f'{arch}/serve']}")
    by_path = {f"{arch}/prefill": per_prefill, f"{arch}/serve": per_serve}

    times = [_sync_s(lambda: model.prefill(params, toks))[1]
             for _ in range(prefill_reps)]
    pre_s = statistics.median(times)
    print(f"{arch} prefill {PREFILL_B} x {PREFILL_S}: {pre_s * 1e3:.1f} ms "
          f"(median of {prefill_reps}), {PREFILL_B * PREFILL_S / pre_s:.0f} "
          "tokens/s")
    step_toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                              (SERVE_SLOTS, 1))).to(dev)
    step_pos = torch.full((SERVE_SLOTS,), 100, device=dev)

    def step():
        return model.decode_step(params, eng.cache, step_toks, step_pos)

    step_ms = statistics.median(_sync_s(step)[1] for _ in range(10)) * 1e3
    print(f"{arch} decode_step {SERVE_SLOTS} slots, cache {SERVE_MAX_SEQ}: "
          f"{step_ms:.2f} ms (median of 10), "
          f"{SERVE_SLOTS / step_ms * 1e3:.1f} tokens/s")
    tr = toks[:, :trace_S]
    tr_ms = (pre_s if trace_S == PREFILL_S else
             _sync_s(lambda: model.prefill(params, tr))[1]) * 1e3
    _breakdown(lambda: model.prefill(params, tr), tr_ms,
               f"{arch} prefill {PREFILL_B} x {tr.shape[1]}")
    if _count(cfg, "attn") or moe_layers:
        v_max, h_max = _fp16_ranges(lambda: model.prefill(params, toks))
        print(f"{arch} prefill: largest |v| into attention {v_max:.4g}, "
              f"largest |h| of the expert FFs {h_max:.4g} (fp16 holds up "
              "to 65504 as it is; the routes scale past it, ROADMAP C13)")
    _breakdown(step, step_ms, f"{arch} decode_step {SERVE_SLOTS} slots")
    return toks, eng, rng, by_path, step


def _decode_vs_prefill(dev, model, params, prompt, cfg):
    """Teacher-forced decode over the prompt against prefill's last
    logits, and the (token, layer) pairs whose experts the two paths
    chose apart."""
    full, pre_routes = _routed(lambda: model.prefill(params, prompt))
    cache = model.init_cache(1, prompt.shape[1], device=dev)
    apart = 0
    for t in range(prompt.shape[1]):
        (last, cache), routes = _routed(lambda: model.decode_step(
            params, cache, prompt[:, t:t + 1], torch.full((1,), t,
                                                          device=dev)))
        apart += sum(_apart(pr[t:t + 1], r)
                     for pr, r in zip(pre_routes, routes))
    return last[:, 0, :cfg.vocab], full[:, :cfg.vocab], apart


def lm_phase(dev, seed: int, reps: int):
    """The dense LM serving path on granite-3-2b, checked and timed;
    returns its kernels' records and its counts by path."""
    cfg = get_config(LM_ARCH)
    model, params = _init(dev, cfg, seed)
    errs = lm_kernel_checks(dev, cfg, seed)
    toks, eng, rng, by_path, _ = serve_path(dev, cfg, model, params, seed)

    # decode matches prefill at full width (tests/test_archs.py's check)
    got, want, _ = _decode_vs_prefill(dev, model, params, toks[:1, :64], cfg)
    e = _compare("decode vs prefill", {"l": got}, {"l": want}, 0.0,
                 DECODE_ATOL)
    print(f"check decode (64 steps) vs prefill logits max abs err {e:.3g} "
          f"(atol {DECODE_ATOL}, rtol 0; logits std {float(want.std()):.3g})")

    # the card (kernels) against the CPU (plain versions), depth 2
    m2 = get_model(dataclasses.replace(cfg, n_layers=2))
    p_cpu = init_params(m2.blueprint(), torch.Generator().manual_seed(seed))
    toks2 = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)))
    want2 = m2.prefill(p_cpu, toks2)
    got2 = m2.prefill(tree_map(lambda a: a.to(dev), p_cpu), toks2.to(dev))
    e = _compare("depth-2 card vs cpu", {"l": got2.cpu()[:, :cfg.vocab]},
                 {"l": want2[:, :cfg.vocab]}, 0.1, 0.1)
    print(f"check depth-2 prefill (2 x 128) card vs cpu logits max abs err "
          f"{e:.3g} (atol = rtol = 0.1)")
    del params, eng
    torch.cuda.empty_cache()
    return lm_kernel_times(dev, cfg, min(reps, 10), errs), by_path


def moe_phase(dev, seed: int, reps: int):
    """The MoE LM serving path on olmoe-1b-7b, checked and timed;
    returns its kernels' records and its counts by path."""
    cfg = get_config(MOE_ARCH)
    model, params = _init(dev, cfg, seed)
    layer0 = {k: params["stack"][0]["moe"][k][0] for k in ("wi", "wo")}
    errs = moe_kernel_checks(dev, cfg, layer0, seed)
    toks, eng, rng, by_path, step = serve_path(dev, cfg, model, params,
                                               seed)

    _print_drops(cfg, model, params, toks, step)

    # decode matches prefill where neither drops (C >= T at T = 64)
    cf = _no_drop_capacity(cfg)
    m8 = get_model(dataclasses.replace(cfg, moe_capacity=cf))
    got, want, apart = _decode_vs_prefill(dev, m8, params,
                                          toks[:1, :DECODE_T], cfg)
    rtol, atol = ROUTED_APART_TOL
    e = _compare("decode vs prefill", {"l": got}, {"l": want}, rtol, atol)
    print(f"check decode (64 steps) vs prefill, capacity factor "
          f"{cf}, logits max abs err {e:.3g} (atol {atol}, "
          f"rtol {rtol}; logits std {float(want.std()):.3g}); (token, "
          f"layer) pairs routed apart: {apart} of {64 * cfg.n_layers}")

    # the card (kernels) against the CPU (plain versions), depth 2
    m2 = get_model(dataclasses.replace(cfg, n_layers=2))
    p_cpu = init_params(m2.blueprint(), torch.Generator().manual_seed(seed))
    toks2 = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128)))
    want2, r_cpu = _routed(lambda: m2.prefill(p_cpu, toks2))
    got2, r_card = _routed(lambda: m2.prefill(
        tree_map(lambda a: a.to(dev), p_cpu), toks2.to(dev)))
    apart = [_apart(a, b) for a, b in zip(r_cpu, r_card)]
    e = _compare("depth-2 card vs cpu", {"l": got2.cpu()[:, :cfg.vocab]},
                 {"l": want2[:, :cfg.vocab]}, 0.1, 0.1)
    print(f"check depth-2 prefill (2 x 128) card vs cpu logits max abs err "
          f"{e:.3g} (atol = rtol = 0.1); tokens whose experts differ "
          f"between card and cpu, by layer: {apart} of {toks2.numel()}")
    del p_cpu, eng
    record, fa128 = moe_kernel_times(dev, cfg, layer0, min(reps, 10), errs)
    del params, layer0
    torch.cuda.empty_cache()
    combine = _combine_row(dev, cfg, min(reps, 10),
                           f"{cfg.n_layers} a prefill or decode step")
    return {"moe_dispatch": record, "flash_attention_d128": fa128,
            "moe_combine": combine}, by_path


def _scan_inputs(g, dev, shape, dtype):
    """dA in (0.5, 0.99), dBx and Cm at scale 0.1, as tests/test_kernels.py
    draws them."""
    B, S, d, n = shape
    dA = torch.rand(B, S, d, n, generator=g, device=dev).mul_(0.49).add_(0.5)
    dBx = torch.randn(B, S, d, n, generator=g, device=dev).mul_(0.1)
    Cm = torch.randn(B, S, n, generator=g, device=dev).mul_(0.1)
    return [t.to(dtype) for t in (dA, dBx, Cm)]


def scan_kernel(dev, cfg, seed, reps):
    """selective_scan at the chunk the path scans, (B, chunk, d_inner, n):
    against its plain version in float32 and bf16, from a given state h,
    and a call chained through h against one call; then the timing row in
    float32, the path's dtype (each call reads and writes h). The bound:
    dA, dBx, Cm and h read, y and h written once; 4 FLOP per state a
    step."""
    g = torch.Generator(dev).manual_seed(seed)
    shape = (PREFILL_B, cfg.ssm_chunk, cfg.ssm_d_inner, cfg.ssm_d_state)
    B, S, d, n = shape
    err = 0.0
    for dt, (rtol, atol) in SCAN_TOL.items():
        dA, dBx, Cm = _scan_inputs(g, dev, shape, dt)
        h0 = torch.randn(B, d, n, generator=g, device=dev)
        h, want_h = h0.clone(), h0.clone()
        want = ss.selective_scan_plain(dA, dBx, Cm, want_h)
        e = _compare(f"selective_scan{shape}", {
            "y": ss.selective_scan(dA, dBx, Cm, h), "h": h},
            {"y": want, "h": want_h}, rtol, atol)
        one = ss.selective_scan(dA, dBx, Cm)
        h = torch.zeros(B, d, n, device=dev)
        parts = [ss.selective_scan(*(t[:, a:b].contiguous()
                                     for t in (dA, dBx, Cm)), h)
                 for a, b in ((0, S // 2), (S // 2, S))]
        e2 = _compare("selective_scan chained", {"y": torch.cat(parts, 1)},
                      {"y": one}, rtol, atol)
        print(f"check selective_scan {shape} {str(dt)[6:]} from a state vs "
              f"plain max abs err {e:.3g}; two calls chained through h vs "
              f"one call {e2:.3g} (rtol {rtol}, atol {atol}; median |y| "
              f"{float(want.float().abs().median()):.3g})")
        if dt == torch.float32:
            err = e
        del dA, dBx, Cm, want, one, parts
    dA, dBx, Cm = _scan_inputs(g, dev, shape, torch.float32)
    h = torch.zeros(B, d, n, device=dev)
    nbytes = 4 * (dA.numel() + dBx.numel() + Cm.numel() + B * S * d
                  + 2 * h.numel())
    row = _kernel_row(
        "selective_scan", f"({B}, {S}, {d}, {n}) float32 with h",
        lambda: ss.selective_scan(dA, dBx, Cm, h),
        lambda: ss.selective_scan_plain(dA, dBx, Cm, h), None, nbytes,
        4 * B * S * d * n, F32_OPS_PER_S, reps,
        f"{_count(cfg, 'mamba')} x {math.ceil(PREFILL_S / S)} a prefill")
    # as training runs it: the state every STATE_EVERY steps kept too
    states = torch.empty(ss.states_shape(*shape), device=dev)
    with_states = _median_ms(
        lambda: ss.selective_scan(dA, dBx, Cm, h, states), reps)
    print(f"time selective_scan {shape} keeping the states "
          f"({states.numel() * 4} B): {with_states:.4f} ms against "
          f"{row['ms']:.4f} ms without")
    return {**row, "max_abs_err": err, "shape": list(shape),
            "ms_with_states": with_states}


def _expert_weights(g, dev, E, d, f):
    """One MoE layer's wi and wo drawn as ``init_params`` draws them
    (normal over the square root of the fan-in, bf16), one expert at a
    time."""
    wi = torch.empty(E, d, 2 * f, dtype=torch.bfloat16, device=dev)
    wo = torch.empty(E, f, d, dtype=torch.bfloat16, device=dev)
    for e in range(E):
        wi[e] = torch.randn(d, 2 * f, generator=g, device=dev).mul_(
            d ** -0.5).bfloat16()
        wo[e] = torch.randn(f, d, generator=g, device=dev).mul_(
            f ** -0.5).bfloat16()
    return wi, wo


def hybrid_moe(dev, cfg, seed, reps):
    """The expert FF at jamba's width, before the model's params exist:
    one layer's 16 experts (``_expert_weights``) checked against the
    plain version at both capacities, then timed (prefill in batches of
    one call: about a second each)."""
    E, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    g = torch.Generator(dev).manual_seed(seed)
    wi, wo = _expert_weights(g, dev, E, d, f)
    errs = {}
    _moe_checks(g, dev, cfg, wi, wo, errs)
    print(f"moe_dispatch slicing of f {f}: " + ", ".join(
        f"C = {C}: {md.slicing(E, C, f)} (slices, width)"
        for C in _moe_shapes(cfg).values())
        + f"; C = 1 with counts: {md.slicing(1, 1, f)}")
    record = _moe_rows(dev, cfg, wi, wo, reps, errs,
                       f"{_count(cfg, ff='moe')} a prefill or decode step",
                       prefill_batch=1)
    del wi, wo
    torch.cuda.empty_cache()
    return record


def hybrid_phase(dev, seed: int, reps: int):
    """The hybrid LM serving path on jamba-1.5-large-398b at full width,
    cut to one layer of each kind; checked and timed. Its kernels are
    checked and timed first, before its params exist. Returns its
    kernels' records and its counts by path."""
    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, **HYBRID_CUT)
    print(f"{HYBRID_ARCH} cut for one card: " + ", ".join(
        f"{k} {getattr(full, k)} -> {v}" for k, v in HYBRID_CUT.items())
        + "; every width as published")
    errs = lm_kernel_checks(dev, cfg, seed)
    records = lm_kernel_times(dev, cfg, min(reps, 10), errs)
    records["moe_dispatch"] = hybrid_moe(dev, cfg, seed, min(reps, 3))
    records["selective_scan"] = scan_kernel(dev, cfg, seed, min(reps, 10))
    torch.cuda.empty_cache()

    model, params = _init(dev, cfg, seed)
    toks, eng, rng, by_path, step = serve_path(dev, cfg, model, params,
                                               seed)
    _print_drops(cfg, model, params, toks, step)
    _decode_checks_routers_zeroed(dev, cfg, params, toks)
    del params, eng, step
    torch.cuda.empty_cache()

    # the card (kernels) against the CPU (plain versions): one period of
    # the smoke config, its routers zeroed (widths cut: the CPU would
    # need 46 GB at full width)
    sm = get_config(HYBRID_ARCH, smoke=True)
    _smoke_card_vs_cpu(dev, dataclasses.replace(
        sm, n_layers=len(sm.layer_pattern())), seed, rng)
    return records, by_path


def _print_drops(cfg, model, params, toks, step) -> None:
    """The share of the first MoE layer's assignments that the capacity
    drops, at prefill and at a decode step (untimed)."""
    first = [k.ff for k in model.period].index("moe")
    for name, fn in (("prefill", lambda: model.prefill(params, toks)),
                     ("decode", step)):
        share = _first_moe_dropped(fn, cfg)
        print(f"{cfg.name} {name}: {share:.4f} of layer {first}'s expert "
              f"assignments dropped by capacity (C = "
              f"{_moe_shapes(cfg)[name]})")


def _decode_checks_routers_zeroed(dev, cfg, params, toks) -> None:
    """Decode matches prefill where neither drops (C >= T at T = 64): with
    the random routers (printed: a token routed apart on the two paths
    moves the logits), then held with the routers zeroed, where both
    paths route every token to the first top_k experts."""
    cf = _no_drop_capacity(cfg)
    m8 = get_model(dataclasses.replace(cfg, moe_capacity=cf))
    moe_layers = _count(cfg, ff="moe")
    got, want, apart = _decode_vs_prefill(dev, m8, params,
                                          toks[:1, :DECODE_T], cfg)
    print(f"decode ({DECODE_T} steps) vs prefill, capacity factor {cf}, "
          f"random routers: logits max abs err "
          f"{float((got - want).abs().max()):.3g} (logits std "
          f"{float(want.std()):.3g}); (token, layer) pairs routed apart: "
          f"{apart} of {DECODE_T * moe_layers}")
    tied = dict(params, stack=[
        dict(layer, moe=dict(layer["moe"], router=torch.zeros_like(
            layer["moe"]["router"]))) if "moe" in layer else layer
        for layer in params["stack"]])
    got, want, apart = _decode_vs_prefill(dev, m8, tied,
                                          toks[:1, :DECODE_T], cfg)
    e = _compare("decode vs prefill", {"l": got}, {"l": want}, 0.0,
                 DECODE_ATOL)
    print(f"check decode ({DECODE_T} steps) vs prefill, capacity factor "
          f"{cf}, routers zeroed, logits max abs err {e:.3g} (atol "
          f"{DECODE_ATOL}, rtol 0; logits std {float(want.std()):.3g}); "
          f"pairs routed apart: {apart}")


def _smoke_card_vs_cpu(dev, sm, seed, rng) -> None:
    """A small config's prefill on the card (kernels) against the CPU
    (plain versions), its routers zeroed, with the card's launches."""
    m2 = get_model(sm)
    p_cpu = init_params(m2.blueprint(), torch.Generator().manual_seed(seed))
    for layer in p_cpu["stack"]:
        if "moe" in layer:
            layer["moe"]["router"].zero_()
    toks2 = torch.from_numpy(rng.integers(0, sm.vocab, (2, 128)))
    want2 = m2.prefill(p_cpu, toks2)
    _zero_counts()
    got2 = m2.prefill(tree_map(lambda a: a.to(dev), p_cpu), toks2.to(dev))
    torch.cuda.synchronize()
    rtol, atol = SMOKE_TOL
    e = _compare("smoke card vs cpu", {"l": got2.cpu()[:, :sm.vocab]},
                 {"l": want2[:, :sm.vocab]}, rtol, atol)
    print(f"check {sm.name} ({sm.n_layers} layers, d_model {sm.d_model}, "
          f"head dim {sm.head_dim}, routers zeroed) prefill (2 x 128) card "
          f"vs cpu logits max abs err {e:.3g} (atol {atol}, rtol {rtol}); "
          f"card launches {_counts()}, by route {_route_counts()}")


def kimi_phase(dev, seed: int, reps: int):
    """The MoE LM serving path on kimi-k2-1t-a32b at full width, cut to
    one layer (its period): 19.4 B params, 38.8 GB in bf16. Checked and
    timed; the expert FF is held against its plain version on
    KIMI_CHECK_EXPERTS of its experts at full d and f, and timed at the
    full shape. Returns its kernels' records and its counts by path."""
    full = get_config(KIMI_ARCH)
    cfg = dataclasses.replace(full, **KIMI_CUT)
    print(f"{KIMI_ARCH} cut for one card: " + ", ".join(
        f"{k} {getattr(full, k)} -> {v}" for k, v in KIMI_CUT.items())
        + "; every width as published")
    model, params = _init(dev, cfg, seed)
    layer0 = {k: params["stack"][0]["moe"][k][0] for k in ("wi", "wo")}
    errs = lm_kernel_checks(dev, cfg, seed)
    _moe_checks(torch.Generator(dev).manual_seed(seed), dev, cfg,
                layer0["wi"], layer0["wo"], errs,
                experts=KIMI_CHECK_EXPERTS)
    toks, eng, rng, by_path, step = serve_path(dev, cfg, model, params,
                                               seed)
    _print_drops(cfg, model, params, toks, step)
    _decode_checks_routers_zeroed(dev, cfg, params, toks)
    del eng, step
    torch.cuda.empty_cache()
    records = lm_kernel_times(dev, cfg, min(reps, 10), errs)
    records["moe_dispatch"] = _moe_rows(
        dev, cfg, layer0["wi"], layer0["wo"], min(reps, 5), errs,
        f"{_count(cfg, ff='moe')} a prefill or decode step",
        prefill_batch=3, plain_experts=KIMI_CHECK_EXPERTS)
    del params, layer0
    torch.cuda.empty_cache()

    # the card against the CPU: kimi's smoke config at its published head
    # dim, 112 (the smoke config has 32), one layer
    sm = dataclasses.replace(get_config(KIMI_ARCH, smoke=True),
                             head_dim=full.head_dim, n_layers=1)
    _smoke_card_vs_cpu(dev, sm, seed, rng)
    return records, by_path


# --------------------------------------------------------------------------
# the recurrent LM serving path: xlstm-1.3b at full width and depth
# --------------------------------------------------------------------------

def _mixer_s(fn) -> tuple:
    """(seconds of one ``fn()`` in the sLSTM layers, in the mLSTM layers,
    in all), each mixer's call between two syncs on the host clock."""
    from repro_torch.models import xlstm as XL
    spent = {"slstm": 0.0, "mlstm": 0.0}
    orig = {"slstm": XL.slstm_seq, "mlstm": XL.mlstm_chunked}

    def timed(name):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return run

    XL.slstm_seq, XL.mlstm_chunked = timed("slstm"), timed("mlstm")
    try:
        _, total = _sync_s(fn)
    finally:
        XL.slstm_seq, XL.mlstm_chunked = orig["slstm"], orig["mlstm"]
    return spent["slstm"], spent["mlstm"], total


#: an xLSTM layer's decode against its prefill on the same input:
#: tests/test_torch_ssm.py's BLOCK_TOL (rtol and atol), a bf16 ulp and more
#: of the residual stream
XLSTM_LAYER_TOL = 3e-2
#: tokens a prompt of xlstm's traced prefill
XLSTM_TRACE_S = 512


def _layers_decode_vs_forward(dev, model, params, prompt, enc_out=None):
    """Each layer's prefill (its chunked mLSTM or sLSTM loop, its
    attention) recorded on ``prompt``, then the same layer's decode steps
    over the positions, fed the recorded input and carrying their own
    cache: held at XLSTM_LAYER_TOL; returns the largest |diff| and the
    largest |residual|. With ``enc_out`` the forward is the decoder's
    against it (``LM._decoder_forward``) and each decode step reads it too."""
    ins, outs = [], []
    apply = model._apply_layer

    def record(kind, p, x, positions, **kw):
        y = apply(kind, p, x, positions, **kw)
        ins.append(x)
        outs.append(y)
        return y

    model._apply_layer = record
    try:
        if enc_out is None:
            model.prefill(params, prompt)
        else:
            model._decoder_forward(params, prompt, enc_out)
    finally:
        del model._apply_layer
    T, P = prompt.shape[1], len(model.period)
    cache = model.init_cache(1, T, device=dev)
    worst = 0.0
    for i in range(model.n_periods):
        pp = tree_map(lambda a: a[i], params["stack"])
        pc = tree_map(lambda a: a[i], cache)
        for k, kind in enumerate(model.period):
            x = ins[i * P + k]
            steps = []
            for t in range(T):
                pos = torch.full((1,), t, device=dev)
                steps.append(model._decode_layer(kind, pp[k], pc[k],
                                                 x[:, t:t + 1], pos[:, None],
                                                 pos, enc_out))
            worst = max(worst, _compare(
                f"layer {i * P + k} decode vs prefill",
                {"y": torch.cat(steps, 1)}, {"y": outs[i * P + k]},
                XLSTM_LAYER_TOL, XLSTM_LAYER_TOL))
    return worst, max(float(o.float().abs().max()) for o in outs)


def xlstm_phase(dev, seed: int, reps: int):
    """The recurrent LM serving path on xlstm-1.3b at full width and
    depth (48 layers, an sLSTM and seven mLSTMs a period, d_model 2048, 4
    heads of 512, no feed-forward, 1.04 B params), whose one kernel is
    rmsnorm: 49 launches a prefill and a decode step (48 ln1 and ln_f).
    Checked and timed; returns rmsnorm's checks and the counts by path."""
    cfg = get_config(XLSTM_ARCH)
    model, params = _init(dev, cfg, seed)
    g = torch.Generator(dev).manual_seed(seed)
    errs = {}
    _rms_checks(g, dev, cfg, errs)
    # one timed prefill (the sLSTM's loop makes each about 4 s), and the
    # trace of where the time goes on 4 x 512 tokens: every mixer's work
    # grows with the tokens, and the trace of 4 x 2048 holds 344 K kernels
    toks, eng, rng, by_path, step = serve_path(dev, cfg, model, params,
                                               seed, prefill_reps=1,
                                               trace_S=XLSTM_TRACE_S)
    s_s, m_s, tot = _mixer_s(lambda: model.prefill(params, toks))
    n_s, n_m = _count(cfg, "slstm"), _count(cfg, "mlstm")
    print(f"{XLSTM_ARCH} prefill {PREFILL_B} x {PREFILL_S} by mixer (each "
          f"call between syncs): {n_s} sLSTM layers {s_s * 1e3:.1f} ms "
          f"({s_s / (n_s * PREFILL_S) * 1e6:.1f} us a step of their "
          f"{n_s * PREFILL_S} sequential steps), {n_m} mLSTM layers "
          f"{m_s * 1e3:.1f} ms ({n_m * math.ceil(PREFILL_S / cfg.xlstm_chunk)}"
          f" chunks of {cfg.xlstm_chunk}), all {tot * 1e3:.1f} ms")

    # decode matches prefill, both causal (the reference's chunked mLSTM
    # is not, ROADMAP C14): each layer, fed prefill's input to it, decodes
    # its outputs at XLSTM_LAYER_TOL; chained over 48 layers the two
    # round bf16 apart and the random-weight model amplifies it (ROADMAP
    # C15), so the logits are printed beside it
    e, scale = _layers_decode_vs_forward(dev, model, params,
                                         toks[:1, :DECODE_T])
    print(f"check decode ({DECODE_T} steps) vs prefill, layer by layer "
          f"(each of the {cfg.n_layers} layers fed prefill's input): max "
          f"abs err {e:.3g} (rtol = atol = {XLSTM_LAYER_TOL}; largest "
          f"|residual| {scale:.3g})")
    got, want, _ = _decode_vs_prefill(dev, model, params,
                                      toks[:1, :DECODE_T], cfg)
    print(f"decode ({DECODE_T} steps) vs prefill, chained through "
          f"{cfg.n_layers} layers: logits max abs err "
          f"{float((got - want).abs().max()):.3g} (logits std "
          f"{float(want.std()):.3g}; not held, ROADMAP C15)")
    del params, eng, step
    torch.cuda.empty_cache()

    # the card against the CPU: the smoke config cut to one period (8
    # layers at d_model 128), 2 x 40 tokens, at tests/test_archs.py's
    # tolerance (the random-weight xLSTM is ill-conditioned in bf16:
    # ROADMAP C15)
    sm = get_config(XLSTM_ARCH, smoke=True)
    sm = dataclasses.replace(sm, n_layers=len(sm.layer_pattern()))
    m2 = get_model(sm)
    p_cpu = init_params(m2.blueprint(), torch.Generator().manual_seed(seed))
    toks2 = torch.from_numpy(rng.integers(0, sm.vocab, (2, 40)))
    want2 = m2.prefill(p_cpu, toks2)
    _zero_counts()
    got2 = m2.prefill(tree_map(lambda a: a.to(dev), p_cpu), toks2.to(dev))
    torch.cuda.synchronize()
    rtol, atol = ROUTED_APART_TOL
    e = _compare("xlstm smoke card vs cpu", {"l": got2.cpu()[:, :sm.vocab]},
                 {"l": want2[:, :sm.vocab]}, rtol, atol)
    if rn.LAUNCHES != sm.n_layers + 1:
        raise AssertionError(f"xlstm smoke card prefill: {rn.LAUNCHES} "
                             "rmsnorm launches")
    print(f"check {sm.name} ({sm.n_layers} layers, d_model {sm.d_model}) "
          f"prefill (2 x 40) card vs cpu logits max abs err {e:.3g} (atol "
          f"{atol}, rtol {rtol}); card launches {_counts()}")
    n = PREFILL_B * PREFILL_S
    return {"rmsnorm": {"shape": f"({n}, {cfg.d_model}) bf16, granite's "
                        "row", "max_abs_err": errs[("rmsnorm", n,
                                                    torch.bfloat16)]}}, \
        by_path


# --------------------------------------------------------------------------
# training: granite-3-2b at full width and depth, with the backward kernels
# --------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 4
#: the backward kernels against their plain versions: the largest
#: |got - want| over the largest |want| of each output
BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
#: the depth-2 step on the card against the CPU: the loss (about 11.2 at
#: init), each leaf's gradient and updated params as relative L2 errors
TRAIN_LOSS_ATOL, TRAIN_GRAD_TOL = 2e-2, 2e-2
CPU_B, CPU_S = 1, 512


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _bwd_check(name, got, want, dtype, errs, labels):
    rels = [_rel(a, b) for a, b in zip(got, want)]
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want))
    if max(rels) > BWD_TOL[dtype] or not all(
            torch.isfinite(a).all() for a in got):
        raise AssertionError(f"{name}: relative errors {rels} past "
                             f"{BWD_TOL[dtype]}")
    errs[name] = max(errs.get(name, 0.0), worst)
    return ", ".join(f"{lab} {r:.3g}" for lab, r in zip(labels, rels))


def _fa_bwd_inputs(g, dev, B, H, Hkv, S, D, dtype):
    q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev).to(dtype)
               .transpose(1, 2) for h in (H, Hkv, Hkv))
    do = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype) \
        .transpose(1, 2)
    return q, k, v, do


#: the train step's scale of do: the mean loss over 4 x 2048 tokens
#: divides every gradient by 8192
TRAIN_DO_SCALE = 1.0 / (TRAIN_B * TRAIN_S)


def train_kernel_checks(dev, cfg, seed) -> dict:
    """Each backward kernel against its plain version at the train path's
    shapes (rmsnorm (8192, 2048); attention (4, 32, 2048, 64) with 8 KV
    heads, causal; head dims 112 and 128 at batch 1), bf16 (attention's
    on the tensor cores) and float32 (the CUDA cores); attention at
    granite's shape once more with do at the train step's scale; the
    forward's lse-writing launch bit for bit the launch without lse; two
    backward calls bit for bit the same."""
    g = torch.Generator(dev).manual_seed(seed)
    errs: dict = {}
    N, d = TRAIN_B * TRAIN_S, cfg.d_model
    for dt in (torch.bfloat16, torch.float32):
        x, s = _rms_inputs(g, dev, N, d, dt)
        dy = torch.randn(N, d, generator=g, device=dev).to(dt)
        y, r = rn.rmsnorm(x, s, with_rstd=True)
        if not torch.equal(y, rn.rmsnorm(x, s)):
            raise AssertionError("rmsnorm: the rstd-writing launch changed "
                                 "the output")
        got = rb.rmsnorm_bwd(x, s, r, dy)
        msg = _bwd_check("rmsnorm_bwd", got, rb.rmsnorm_bwd_plain(
            x, s, r, dy), dt, errs, ("dx", "dscale"))
        again = rb.rmsnorm_bwd(x, s, r, dy)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not same:
            raise AssertionError("rmsnorm_bwd: two calls differ")
        print(f"check rmsnorm_bwd ({N}, {d}) {str(dt)[6:]} vs plain, "
              f"largest relative error {msg} (tol {BWD_TOL[dt]}); the "
              f"forward with rstd equal to without; two calls bit for bit "
              f"equal: {same}")
        del x, s, dy, y, r, got, again
    shapes = [(TRAIN_B, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 1.0),
              (TRAIN_B, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
               TRAIN_DO_SCALE),
              (1, 64, 8, 112, 1.0), (1, 16, 16, 128, 1.0)]
    for B, H, Hkv, D, do_scale in shapes:
        for dt in (torch.bfloat16, torch.float32):
            if do_scale != 1.0 and dt != torch.bfloat16:
                continue
            q, k, v, do = _fa_bwd_inputs(g, dev, B, H, Hkv, TRAIN_S, D, dt)
            if do_scale != 1.0:
                do = (do.float() * do_scale).to(dt)
            way = fb.route(dt, D, fa._rows_aligned(q, k, v, do))
            o, lse = fa.flash_attention(q, k, v, causal=True, with_lse=True)
            same_o = torch.equal(o, fa.flash_attention(q, k, v, causal=True))
            _, want_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                                   with_lse=True)
            e_lse = _rel(lse, want_lse)
            if not same_o or e_lse > 1e-5:
                raise AssertionError(f"flash_attention lse: out equal "
                                     f"{same_o}, lse error {e_lse}")
            got = fb.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
            msg = _bwd_check("flash_attention_bwd", got,
                             fb.flash_attention_bwd_plain(
                                 q, k, v, o, do, lse, causal=True),
                             dt, errs, ("dq", "dk", "dv"))
            again = fb.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if not same:
                raise AssertionError("flash_attention_bwd: two calls differ")
            print(f"check flash_attention_bwd ({B}, {H}, {TRAIN_S}, {D}) kv "
                  f"heads {Hkv} causal {str(dt)[6:]} do x {do_scale:.6g} "
                  f"({way}) vs plain, largest "
                  f"relative error {msg} (tol {BWD_TOL[dt]}); the forward's "
                  f"out with lse bit for bit the out without: {same_o}, lse "
                  f"relative error {e_lse:.3g}; two calls bit for bit "
                  f"equal: {same}")
            del q, k, v, do, o, lse, want_lse, got, again
            torch.cuda.empty_cache()
    return errs


def _backward_only(fn, inputs, grad_out):
    """torch.autograd.grad of ``fn(*inputs)`` against ``grad_out``, the
    forward run once beforehand: what is timed is the backward."""
    leaves_ = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves_)
    return lambda: torch.autograd.grad(out, leaves_, grad_out,
                                       retain_graph=True)


def train_kernel_times(dev, cfg, reps, errs, launches) -> dict:
    """Timing rows of the two backward kernels at the train path's
    shapes, bf16. The bound: rmsnorm's bytes (x, dy read, dx written,
    scale, rstd, dscale); attention's five products a (query, key) pair
    under the mask at the tensor cores' bf16 peak (the CUDA cores'
    float32 bound printed beside it) or its bytes (q, k, v, o, do, lse
    read, dq, dk, dv written). The yardstick: ``torch.autograd.grad``
    through ``F.rms_norm`` and through ``scaled_dot_product_attention``
    (``enable_gqa``), their forwards run beforehand."""
    g = torch.Generator(dev).manual_seed(11)
    N, d = TRAIN_B * TRAIN_S, cfg.d_model
    sets = [(*_rms_inputs(g, dev, N, d, torch.bfloat16),
             torch.randn(N, d, generator=g, device=dev).bfloat16())
            for _ in range(4)]
    sets = [(x, s, rn.rmsnorm(x, s, with_rstd=True)[1], dy)
            for x, s, dy in sets]
    cyc = itertools.cycle(sets)
    x, s, _, dy = sets[0]
    lib = _backward_only(lambda x, s: F.rms_norm(x, (d,), s, 1e-6), (x, s),
                         dy)
    records = {"rmsnorm_bwd": {**_kernel_row(
        "rmsnorm_bwd", f"({N}, {d}) bf16",
        lambda: rb.rmsnorm_bwd(*next(cyc)),
        lambda: rb.rmsnorm_bwd_plain(*next(cyc)), lib,
        3 * N * d * 2 + 2 * d * 2 + N * 4, 10 * N * d, F32_OPS_PER_S, reps,
        launches["rmsnorm_bwd"]), "max_abs_err": errs["rmsnorm_bwd"],
        "shape": [N, d]}}
    del sets, cyc, lib
    B, H, Hkv, S, D = (TRAIN_B, cfg.n_heads, cfg.n_kv_heads, TRAIN_S,
                       cfg.head_dim)
    q, k, v, do = _fa_bwd_inputs(g, dev, B, H, Hkv, S, D, torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, causal=True, with_lse=True)
    pairs = S * (S + 1) // 2
    ops = 2 * 5 * B * H * D * pairs
    nbytes = 2 * (4 * B * H * S * D + 4 * B * Hkv * S * D) + 4 * B * H * S
    lib = _backward_only(
        lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), (q, k, v), do)
    row = _kernel_row(
        "flash_attention_bwd", f"({B}, {H}, {S}, {D}) kv {Hkv} causal bf16",
        lambda: fb.flash_attention_bwd(q, k, v, o, do, lse, causal=True),
        lambda: fb.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                             causal=True), lib,
        nbytes, ops, BF16_OPS_PER_S, min(reps, 5),
        launches["flash_attention_bwd"], batch=3, calls=6)
    print(f"flash_attention_bwd bound at the CUDA cores' float32 peak: "
          f"{ops / F32_OPS_PER_S * 1e3:.4f} ms ({ops:.4g} FLOP)")
    records["flash_attention_bwd"] = {
        **row, "max_abs_err": errs["flash_attention_bwd"],
        "shape": [B, H, Hkv, S, D],
        "bound_cuda_cores_ms": ops / F32_OPS_PER_S * 1e3}
    return records


def _leaf_names(tree, path="") -> list:
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{path}/{i}")]
    return [path]


def _zero_routers(params) -> None:
    """Every MoE layer's router set to zero in place: all tokens route to
    the first top_k experts on either device (bf16 near-ties in random
    routers route tokens apart, tests/test_torch_train.py)."""
    for layer in params["stack"]:
        if "moe" in layer:
            layer["moe"]["router"].zero_()


def _train_card_vs_cpu(dev, cfg, seed, batch=None, label="depth 2",
                       adamw=True, opt=None, grads=True) -> None:
    """One step of a short model at full width (granite's: depth 2) on
    the card and on the CPU (plain versions) from the same params (drawn
    on the card, copied to the host; MoE routers zeroed) and batch
    (granite's: 1 x 512 tokens): the loss, each leaf's gradient and, with
    ``adamw``, each leaf after AdamW (``opt``, default float32 moments).
    ``cfg`` is the short config. ``grads`` False: the gradients are
    printed, not held (ROADMAP C15: a whole random-weight hybrid period
    in bf16 is too ill-conditioned to hold them)."""
    m2 = get_model(cfg)
    p_card = init_params(m2.blueprint(), torch.Generator(dev).manual_seed(
        seed))
    _zero_routers(p_card)
    p_cpu = tree_map(lambda a: a.cpu(), p_card)
    if batch is None:
        batch = {"tokens": torch.from_numpy(synthetic_batch(DataConfig(
            vocab=cfg.vocab, seq_len=CPU_S, global_batch=CPU_B, seed=seed),
            0)["tokens"])}
    shape = " x ".join(map(str, batch["tokens"].shape))
    t0 = time.perf_counter()
    l_cpu, g_cpu = value_and_grad(m2, p_cpu, batch, remat=True)
    cpu_s = time.perf_counter() - t0
    l_card, g_card = value_and_grad(
        m2, p_card, {k: v.to(dev) for k, v in batch.items()}, remat=True)
    names = _leaf_names(g_cpu)
    gerr = {n: float((a.cpu().float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))
            for n, a, b in zip(names, leaves(g_card), leaves(g_cpu))
            if b.float().any()}
    zero = [n for n, b in zip(names, leaves(g_cpu)) if not b.float().any()]
    zero_card = [n for n, a in zip(names, leaves(g_card))
                 if not a.float().any()]
    perr: dict = {}
    # a leaf that starts at zero (a zeroed router) holds after one AdamW
    # step only lr * m / (sqrt(v) + eps), about lr * sign(g): an element
    # whose gradient is near zero takes either sign on the two devices,
    # so such a leaf is held by its gradient above, not by its params
    from_zero = [n for n, b in zip(names, leaves(p_cpu))
                 if not b.float().any()]
    if adamw:
        opt = opt or AdamWConfig()
        adamw_update(p_cpu, g_cpu, init_opt_state(p_cpu, opt), opt)
        adamw_update(p_card, g_card, init_opt_state(p_card, opt), opt)
        perr = {n: float((a.cpu().float() - b.float()).norm()
                         / b.float().norm().clamp_min(1e-30))
                for n, a, b in zip(names, leaves(p_card), leaves(p_cpu))
                if n not in from_zero}
    gap = abs(float(l_card) - float(l_cpu))
    print(f"check train step {label}, full width ({shape}) {cfg.name} card "
          f"vs cpu: loss {float(l_card):.6f} vs {float(l_cpu):.6f}, gap "
          f"{gap:.3g} (atol {TRAIN_LOSS_ATOL}); gradient relative L2 "
          f"errors " + ", ".join(f"{n} {e:.3g}" for n, e in gerr.items())
          + (f" (tol {TRAIN_GRAD_TOL})" if grads else
             " (not held: ROADMAP C15)")
          + "; zero gradients on both sides "
          f"{zero}; " + (f"params after AdamW, largest "
                         f"{max(perr.values()):.3g} ("
                         f"{max(perr, key=perr.get)}; leaves from zero, "
                         f"held by their gradients: {from_zero}); "
                         if perr else "AdamW not run; ")
          + f"the CPU's value_and_grad {cpu_s:.1f} s")
    if gap > TRAIN_LOSS_ATOL or zero != zero_card or not all(
            math.isfinite(e) for e in gerr.values()) or grads and (
            max(gerr.values()) > TRAIN_GRAD_TOL
            or max(perr.values(), default=0.0) > TRAIN_GRAD_TOL):
        raise AssertionError("train step: card against cpu past tolerance")


def _train_resume(dev, cfg, seed, ckpt_root: Path, opt=None) -> None:
    """At depth 2 (full width): 2 steps, a checkpoint, a fresh train_loop
    that resumes for 2 more; its losses must equal 4 uninterrupted steps
    bit for bit (the backward kernels sum in a fixed order). ``opt``:
    AdamW's config, default float32 moments."""
    m2 = get_model(dataclasses.replace(cfg, n_layers=2))
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B,
                      seed=seed)
    scfg = StepConfig(remat=True, opt=opt or AdamWConfig())
    quiet = dict(log_every=0)
    straight = train_loop(m2, data, LoopConfig(total_steps=4,
                                               ckpt_every=10**9, **quiet),
                          scfg, str(ckpt_root / "straight"), device=dev)
    first = train_loop(m2, data, LoopConfig(total_steps=2, ckpt_every=2,
                                            **quiet),
                       scfg, str(ckpt_root / "resumed"), device=dev)
    t0 = time.perf_counter()
    rest = train_loop(m2, data, LoopConfig(total_steps=4, ckpt_every=10**9,
                                           **quiet),
                      scfg, str(ckpt_root / "resumed"), device=dev)
    resume_s = time.perf_counter() - t0
    both = first.losses + rest.losses
    print(f"check resume depth 2: 4 steps straight {straight.losses}; 2, a "
          f"checkpoint, 2 resumed from step {rest.resumed_from} {both} "
          f"(resume and 2 steps {resume_s:.1f} s): bit for bit equal "
          f"{both == straight.losses}")
    if rest.resumed_from != 2 or both != straight.losses:
        raise AssertionError("resumed losses differ from the straight run")


def train_phase(dev, seed: int, reps: int):
    """granite-3-2b trained at full width and depth on the card: the
    backward kernels checked and timed, then TRAIN_STEPS steps through
    ``train_loop`` (counted), the step's breakdown, every leaf's
    gradient, the depth-2 step against the CPU and the depth-2 resume.
    Returns the backward kernels' records, the counts of the path and
    the steps' numbers."""
    cfg = get_config(LM_ARCH)
    errs = train_kernel_checks(dev, cfg, seed)
    per_step = {"rmsnorm": 2 * (2 * cfg.n_layers) + 1,
                "rmsnorm_bwd": 2 * cfg.n_layers + 1,
                "flash_attention": 2 * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers}
    model = get_model(cfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B,
                      seed=seed)
    scfg = StepConfig(remat=True, opt=AdamWConfig())
    params, secs = _sync_s(lambda: init_params(
        model.blueprint(), torch.Generator(dev).manual_seed(data.seed)))
    print(f"train {cfg.name}: {count_params(model.blueprint())} params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads ({cfg.n_kv_heads} kv) x {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}; AdamW moments "
          f"{str(scfg.opt.state_dtype)[6:]}, remat; {TRAIN_B} x {TRAIN_S} "
          f"tokens a step; init on the card {secs:.2f} s")
    ckpt_root = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    res = train_loop(model, data, LoopConfig(
        total_steps=TRAIN_STEPS, ckpt_every=10**9, log_every=1), scfg,
        str(ckpt_root / "full"), params=params, device=dev)
    torch.cuda.synchronize()
    counts = _counts()
    ROUTE_COUNTS[f"{cfg.name}/train"] = _route_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {k: per_step.get(k, 0) * TRAIN_STEPS for k in KERNELS}
    if counts != want:
        raise AssertionError(f"train launched {counts}; expected {want}")
    for name, by_route in ROUTE_COUNTS[f"{cfg.name}/train"].items():
        if by_route != {"tensor_cores": counts[name], "cuda_cores": 0}:
            raise AssertionError(f"train: {name} launched {by_route} by "
                                 "route; every launch must take the "
                                 "tensor cores")
    if not all(math.isfinite(x) for x in res.losses + res.grad_norms) \
            or min(res.grad_norms) <= 0:
        raise AssertionError(f"train: losses {res.losses}, grad norms "
                             f"{res.grad_norms}")
    tps = TRAIN_B * TRAIN_S * (TRAIN_STEPS - 1) / (sum(res.step_ms[1:]) / 1e3)
    for i, (l, gn, ms) in enumerate(zip(res.losses, res.grad_norms,
                                        res.step_ms)):
        print(f"train step {i}: loss {l:.6f} grad_norm {gn:.6f} {ms:.1f} ms")
    print(f"{cfg.name} train main path: {TRAIN_STEPS} steps, "
          f"{tps:.0f} tokens/s over steps 1-{TRAIN_STEPS - 1}, peak memory "
          f"{peak:.2f} GB (max_memory_allocated); launches {counts}, by "
          f"route {ROUTE_COUNTS[f'{cfg.name}/train']}")

    # every leaf's gradient at the trained params (uncounted)
    batch = {"tokens": torch.from_numpy(synthetic_batch(
        data, TRAIN_STEPS)["tokens"]).to(dev)}
    _, grads = value_and_grad(model, params, batch, remat=True)
    norms = {n: float(t.float().norm())
             for n, t in zip(_leaf_names(grads), leaves(grads))}
    bad = {n: v for n, v in norms.items() if not math.isfinite(v) or v <= 0}
    print("train gradient norms by leaf: " + ", ".join(
        f"{n} {v:.4g}" for n, v in norms.items()))
    if bad:
        raise AssertionError(f"train: leaves without a gradient {bad}")
    del grads

    # where one step's time goes (a fresh optimizer state; uncounted)
    step = build_train_step(model, scfg)
    opt = init_opt_state(params, scfg.opt)
    step_ms = statistics.median(res.step_ms[1:])
    _breakdown(lambda: step(params, opt, batch), step_ms,
               f"{cfg.name} train step {TRAIN_B} x {TRAIN_S}")
    del params, opt, batch, step, model
    torch.cuda.empty_cache()
    records = train_kernel_times(
        dev, cfg, min(reps, 10), errs,
        {k: f"{per_step[k]} a step" for k in per_step})
    summary = {"arch": cfg.name, "tokens_per_step": TRAIN_B * TRAIN_S,
               "tokens_per_s": tps, "step_ms": res.step_ms,
               "losses": res.losses, "grad_norms": res.grad_norms,
               "peak_gb": peak}
    torch.cuda.empty_cache()
    _train_card_vs_cpu(dev, dataclasses.replace(cfg, n_layers=2), seed)
    _train_resume(dev, cfg, seed, ckpt_root)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    return records, {f"{cfg.name}/train": counts}, summary


# --------------------------------------------------------------------------
# MoE and hybrid training: olmoe-1b-7b at full width and depth, jamba's
# two-layer cut at full width
# --------------------------------------------------------------------------

#: jamba's gradient on one card: every width, one mamba layer (dense FF)
#: and one attention layer (MoE FF), 11.9 B params
HYBRID_TRAIN_CUT = {"n_layers": 2, "attn_every_k": 2}
#: jamba's expert FF backward is held against its plain version on this
#: many of its 16 experts, and its plain version timed this many at a
#: time over all 16 (the plain version's float32 weights are 2.4 GB an
#: expert)
JAMBA_CHECK_EXPERTS = 2
#: value_and_grad calls of the jamba cut (no optimizer step)
HYBRID_GRAD_STEPS = 3
#: the MoE's bf16 AdamW moments: float32 ones would take olmoe's state to
#: 83 GB, past the card's 80 (the reference's own option)
MOE_OPT = AdamWConfig(state_dtype=torch.bfloat16)


def _train_launches(cfg) -> dict:
    """Kernel launches of one value_and_grad of ``loss_fn`` with remat,
    4 x 2048 tokens: each forward kernel twice (the period's recompute),
    the scan three times (a checkpoint region a chunk inside the
    period's), each backward kernel once, the combine's gather three
    times (the forward, its recompute, the dispatch's gradient)."""
    L, n_attn = cfg.n_layers, _count(cfg, "attn")
    n_moe, n_mamba = _count(cfg, ff="moe"), _count(cfg, "mamba")
    chunks = n_mamba * math.ceil(TRAIN_S / cfg.ssm_chunk)
    norms = 2 * L - _count(cfg, ff="none")
    return {"rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1,
            "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
            "moe_dispatch": 2 * n_moe, "moe_dispatch_bwd": n_moe,
            "moe_combine": 3 * n_moe, "selective_scan": 3 * chunks,
            "selective_scan_bwd": chunks}


def _expert_bwd_inputs(g, dev, cfg, E):
    """x (unit-RMS rows, as an RMSNorm hands them), dy and the counts of
    a random routing of the prefill's 4 x 2048 tokens, at the prefill's
    capacity, on E experts; x's rows past the counts zeroed, as the
    dispatch's zero row leaves them."""
    C = _moe_shapes(cfg)["prefill"]
    counts = _sim_counts(g, dev, cfg, PREFILL_B * PREFILL_S, C)[:E]
    counts = counts.contiguous()
    live = (torch.arange(C, device=dev)[None, :] < counts[:, None])[..., None]
    x = (torch.randn(E, C, cfg.d_model, generator=g, device=dev)
         * live).bfloat16()
    dy = torch.randn(E, C, cfg.d_model, generator=g, device=dev).bfloat16()
    return x, dy, counts


def _expert_bwd_check(g, dev, cfg, wi, wo, errs, experts=None) -> None:
    """The expert FF's backward on the tensor cores against its plain
    version at the path's prefill capacity, bf16, with the counts of a
    random routing, from the forward's saved pre-activation gu (itself
    held against the float32 up product, one bf16 rounding of its largest
    value, its rows past the count left unwritten); two calls bit for bit
    the same, and the
    Function's gradient (its forward keeping gu) the direct call's bit
    for bit. Then the CUDA-core route's ``swiglu_bwd`` kernel alone, in
    float32 and bf16, against its plain version, each call counted on
    that route. ``experts``: on the first that many experts only (full d
    and f)."""
    E = cfg.moe_experts if experts is None else experts
    wi, wo = wi[:E], wo[:E]
    x, dy, counts = _expert_bwd_inputs(g, dev, cfg, E)
    C, f = x.shape[1], cfg.moe_d_ff
    gu = torch.full((E, C, 2 * f), float("nan"), dtype=torch.bfloat16,
                    device=dev)
    md.grouped_expert_ff(x, wi, wo, counts, gu)
    live = md.live_rows(counts, C, dev)[..., 0]
    up = torch.bmm(x.float(), wi.float())   # float32, x's dead rows zero
    gu_err = _rel(gu[live], up[live])
    untouched = bool(torch.isnan(gu[~live].float()).all())
    del up
    if gu_err > 2.0**-8 or not untouched:
        raise AssertionError(f"grouped_expert_ff gu: largest error over "
                             f"largest value {gu_err} (tol 2^-8); rows past "
                             f"the count untouched: {untouched}")
    got = mb.grouped_expert_ff_bwd(x, wi, wo, dy, counts, gu)
    msg = _bwd_check("moe_dispatch_bwd", got, mb.grouped_expert_ff_bwd_plain(
        x, wi, wo, dy, counts), torch.bfloat16, errs, ("dx", "dwi", "dwo"))
    again = mb.grouped_expert_ff_bwd(x, wi, wo, dy, counts, gu)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again, gu
    leaves_ = [t.detach().clone().requires_grad_() for t in (x, wi, wo)]
    mb.GroupedExpertFF.apply(*leaves_, counts, True).backward(dy)
    fn_same = all(torch.equal(t.grad, a) for t, a in zip(leaves_, got))
    print(f"check expert FF backward ({E}, {C}, {cfg.d_model}) f {f} bf16 "
          f"on the tensor cores, {int(counts.sum())} rows filled, from the "
          f"forward's gu (its largest error over the float32 up product's "
          f"largest value {gu_err:.3g}, tol 2^-8: one bf16 rounding; rows "
          f"past the count untouched): vs "
          f"plain largest relative error {msg} (tol "
          f"{BWD_TOL[torch.bfloat16]}); two calls bit for bit equal: "
          f"{same}; the Function's gradient the direct call's bit for bit: "
          f"{fn_same}" + ("" if experts is None else
                          f"; on {E} of {cfg.moe_experts} experts"))
    if not (same and fn_same):
        raise AssertionError("grouped_expert_ff_bwd: two calls or the "
                             "Function's gradient differ")
    del got, leaves_
    up = torch.bmm(x, wi)
    dh = torch.bmm(dy, wo.transpose(1, 2))
    msgs = []
    for t in (torch.float32, torch.bfloat16):
        a, b = up.to(t), dh.to(t)
        n0 = mb.LAUNCHES_BY_ROUTE["cuda_cores"]
        got = mb.swiglu_bwd(a, b, counts)
        if mb.LAUNCHES_BY_ROUTE["cuda_cores"] != n0 + 1:
            raise AssertionError("swiglu_bwd: no launch counted on the "
                                 "cuda_cores route")
        msgs.append(f"{str(t)[6:]} " + _bwd_check(
            "swiglu_bwd", got, mb.swiglu_bwd_plain(a, b, counts), t, errs,
            ("dgu", "h")) + f" (tol {BWD_TOL[t]})")
        del a, b, got
    print(f"check swiglu_bwd ({E}, {C}, {f}), the cuda_cores route's "
          f"kernel, vs plain largest relative error: " + "; ".join(msgs))
    del up, dh
    torch.cuda.empty_cache()


def _expert_bwd_rows(dev, cfg, wi, wo, reps, errs, launches, batch=3,
                     plain_experts=None) -> dict:
    """Timing row of the expert FF's backward on the tensor cores at the
    prefill capacity with the counts of a random routing, from the
    forward's saved pre-activation. The bound: 12 FLOP a filled row and
    (d, f) pair (dh 2, dx 4, dwi 4, dwo 2; the cuBLAS route, which runs
    the up product again, does 16) at the tensor cores' bf16 peak, or x,
    dy, wi, wo read and dx, dwi, dwo written once. Yardstick:
    ``torch.autograd.grad`` through the three-call ``_library_moe`` on x
    with the rows past the counts zero, the same function (12 FLOP on
    every row). Then the CUDA-core route's ``swiglu_bwd`` kernel alone
    on bf16 (bound: the filled rows' g, u, dh read, every row's dgu and h
    written). ``plain_experts``: the plain version runs that many
    experts a call, in turn over all of them (its float32 weights and
    gradients would not fit at once)."""
    g = torch.Generator(dev).manual_seed(13)
    E, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    x, dy, counts = _expert_bwd_inputs(g, dev, cfg, E)
    C, rows = x.shape[1], int(counts.sum())
    gu = torch.empty(E, C, 2 * f, dtype=torch.bfloat16, device=dev)
    md.grouped_expert_ff(x, wi, wo, counts, gu)
    step = E if plain_experts is None else plain_experts
    lib = _backward_only(_library_moe, (x, wi, wo), dy)
    nbytes = 2 * (3 * E * C * d + 2 * E * d * 2 * f + 2 * E * f * d)

    def plain():
        for a in range(0, E, step):     # each slice's gradients dropped
            mb.grouped_expert_ff_bwd_plain(
                x[a:a + step], wi[a:a + step], wo[a:a + step],
                dy[a:a + step], counts[a:a + step])

    row = _kernel_row(
        "expert FF bwd", f"({E}, {C}, {d}) f {f} bf16, {rows} rows",
        lambda: mb.grouped_expert_ff_bwd(x, wi, wo, dy, counts, gu), plain,
        lib, nbytes, 12 * rows * d * f, BF16_OPS_PER_S, reps, launches,
        batch=batch, calls=2 * batch)
    if step != E:
        print(f"expert FF bwd plain: {step} experts a call, in turn over "
              f"all {E}")
    del lib, gu
    torch.cuda.empty_cache()
    gu = torch.bmm(x, wi)
    dh = torch.bmm(dy, wo.transpose(1, 2))
    sw = _kernel_row(
        "swiglu_bwd", f"({E}, {C}, {f}) bf16, {rows} rows",
        lambda: mb.swiglu_bwd(gu, dh, counts),
        lambda: mb.swiglu_bwd_plain(gu, dh, counts), None,
        2 * (3 * rows * f + 3 * E * C * f), 20 * rows * f, F32_OPS_PER_S,
        reps, "the cuda_cores route's (float32 on the card-vs-CPU layers)")
    del gu, dh
    torch.cuda.empty_cache()
    print("library for the expert FF backward: torch.autograd.grad through "
          "bmm, silu times mul, bmm (bf16), its forward run beforehand; the "
          "bound counts 12 FLOP a filled row and (d, f) pair (the route's "
          "four products), not the 16 of the cuBLAS route, which runs the "
          "up product again")
    return {**row, "max_abs_err": errs["moe_dispatch_bwd"],
            "shape": [E, C, d, f], "rows_filled": rows,
            "route": "tensor_cores",
            "kernels": ["moe_dh_tc", "moe_dx_tc", "moe_dw_tc"],
            "library": "torch.autograd.grad of bmm, silu * mul, bmm (bf16)",
            "swiglu_pass": {"max_abs_err": errs["swiglu_bwd"], **{
                k: sw[k] for k in ("ms", "device_ms", "bound_ms", "bound_by",
                                   "plain_ms")}}}


def _same_step_twice(dev, cfg, seed, opt) -> None:
    """Two ``build_train_step`` steps from the same params, moments and
    batch (4 x 2048 tokens): the loss and every leaf after AdamW equal bit
    for bit."""
    model = get_model(cfg)
    p0 = init_params(model.blueprint(), torch.Generator(dev).manual_seed(
        seed + 3))
    batch = {"tokens": torch.from_numpy(synthetic_batch(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B,
        seed=seed), 1)["tokens"]).to(dev)}
    step = build_train_step(model, StepConfig(remat=True, opt=opt))
    outs = []
    for _ in range(2):
        p = tree_map(lambda a: a.clone(), p0)
        _, _, m = step(p, init_opt_state(p, opt), batch)
        outs.append((float(m["loss"]), p))
    same = outs[0][0] == outs[1][0] and all(
        torch.equal(a, b) for a, b in zip(leaves(outs[0][1]),
                                          leaves(outs[1][1])))
    print(f"check two identical steps {cfg.name} depth {cfg.n_layers}: "
          f"losses {outs[0][0]!r}, {outs[1][0]!r}; every leaf after AdamW "
          f"bit for bit equal: {same}")
    if not same:
        raise AssertionError("two identical train steps differ")


def _moe_ff_card_vs_cpu(dev, cfg, seed) -> None:
    """Two MoE layers of ``cfg`` at full width in series (h + moe_ff(h),
    twice) in float32 with random routers, on the card (kernels) and on
    the CPU (plain versions), CPU_B x CPU_S tokens: the output at
    BWD_TOL and the gradients of x and of each layer's router, wi and wo
    at TRAIN_GRAD_TOL. Random routers, the first top_k experts favoured
    (their columns times 4, as an unbalanced router is), fill the experts
    raggedly and make the capacity drop assignments, through
    GroupedExpertFF, _Dispatch and _Combine, which the step with zeroed
    routers (every token on the same top_k experts) leaves out; float32
    keeps the routers' near-ties from routing the two devices apart, as
    bf16's would."""
    E, k, d, f = cfg.moe_experts, cfg.moe_top_k, cfg.d_model, cfg.moe_d_ff
    gen = torch.Generator().manual_seed(seed + 5)
    favour = torch.ones(E)
    favour[:k] = 4.0
    layers = [{"router": torch.randn(d, E, generator=gen) / math.sqrt(d)
               * favour,
               "wi": torch.randn(E, d, 2 * f, generator=gen) / math.sqrt(d),
               "wo": torch.randn(E, f, d, generator=gen) / math.sqrt(f)}
              for _ in range(2)]
    x = torch.randn(CPU_B, CPU_S, d, generator=gen)
    w = torch.randn(CPU_B, CPU_S, d, generator=gen)
    kw = dict(n_experts=E, top_k=k, capacity_factor=cfg.moe_capacity)
    out = {}
    routes = dict(mb.LAUNCHES_BY_ROUTE)
    for where in ("cpu", dev):
        ps = [{n: v.to(where, copy=True).requires_grad_()
               for n, v in p.items()} for p in layers]
        xs = x.to(where, copy=True).requires_grad_()
        h, aux = xs, 0.0
        for p in ps:
            y, a = MOE.moe_ff(p, h, **kw)
            h, aux = h + y, aux + a
        ((h * w.to(where)).sum() + aux).backward()
        out[str(where)] = (h.detach().cpu(), {"x": xs.grad.cpu(), **{
            f"{i}.{n}": v.grad.cpu() for i, p in enumerate(ps)
            for n, v in p.items()}})
    torch.cuda.synchronize()
    routes = {k: v - routes[k] for k, v in mb.LAUNCHES_BY_ROUTE.items()}
    if routes != {"tensor_cores": 0, "cuda_cores": 2}:
        raise AssertionError(f"moe_ff float32 backward launched {routes} "
                             "by route; expected swiglu_bwd once a layer")
    (h_cpu, g_cpu), (h_card, g_card) = out["cpu"], out[str(dev)]
    T = CPU_B * CPU_S
    C = MOE.capacity(T, k, E, cfg.moe_capacity)
    _, _, idx = MOE.route(layers[0], x.reshape(T, d), k)
    load = torch.bincount(idx.reshape(-1), minlength=E).clamp_max(C)
    partial = int(((load > 0) & (load < C)).sum())
    drop = MOE.dropped_share(layers[0], x, **kw)
    eh = _rel(h_card, h_cpu)
    errs = {n: float((g_card[n] - g_cpu[n]).norm()
                     / g_cpu[n].norm().clamp_min(1e-30)) for n in g_cpu}
    print(f"check {cfg.name} moe_ff x 2 layers, full width, float32, random "
          f"routers ({CPU_B} x {CPU_S} tokens, capacity {C}) card vs cpu: "
          f"first layer {partial} of {E} experts partly filled, "
          f"{int((load == 0).sum())} empty, {int((load == C).sum())} full, "
          f"{drop:.3f} of the assignments dropped; output relative error "
          f"{eh:.3g} (tol {BWD_TOL[torch.float32]}); gradient relative L2 "
          "errors " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
          + f" (tol {TRAIN_GRAD_TOL}); the card's backward by route "
          f"{routes} (float32: swiglu_bwd between cuBLAS products)")
    if partial == 0 or drop == 0:
        raise AssertionError("moe_ff card vs cpu: the routing is not ragged")
    if eh > BWD_TOL[torch.float32] or not all(
            math.isfinite(e) for e in errs.values()) \
            or max(errs.values()) > TRAIN_GRAD_TOL:
        raise AssertionError("moe_ff: card against cpu past tolerance")


def moe_train_phase(dev, seed: int, reps: int):
    """olmoe-1b-7b trained at full width and depth on the card: the expert
    FF's backward checked and timed at a layer's shape, then TRAIN_STEPS
    steps through ``train_loop`` (counted, bf16 AdamW moments), the
    step's breakdown; then at depth 2 the step card vs CPU, a resume bit
    for bit and two identical steps bit for bit. Returns the backward's
    record, the counts of the path and the steps' numbers."""
    cfg = get_config(MOE_ARCH)
    label = f"{cfg.name}/train"
    g = torch.Generator(dev).manual_seed(seed)
    wi, wo = _expert_weights(g, dev, cfg.moe_experts, cfg.d_model,
                             cfg.moe_d_ff)
    errs: dict = {}
    _expert_bwd_check(g, dev, cfg, wi, wo, errs)
    per_step = _train_launches(cfg)
    record = _expert_bwd_rows(dev, cfg, wi, wo, min(reps, 10), errs,
                              f"{per_step['moe_dispatch_bwd']} a step")
    del wi, wo
    torch.cuda.empty_cache()

    model = get_model(cfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B,
                      seed=seed)
    scfg = StepConfig(remat=True, opt=MOE_OPT)
    params, secs = _sync_s(lambda: init_params(
        model.blueprint(), torch.Generator(dev).manual_seed(data.seed)))
    n = count_params(model.blueprint())
    print(f"train {cfg.name}: {n} params, {cfg.n_layers} layers, "
          f"{cfg.moe_experts} experts of d_ff {cfg.moe_d_ff}, top-"
          f"{cfg.moe_top_k}, capacity factor {cfg.moe_capacity}; reduced: "
          f"AdamW moments {str(MOE_OPT.state_dtype)[6:]} (float32 ones: "
          f"{n * 2 * 2 / 1e9:.1f} GB of params and grads and "
          f"{n * 8 / 1e9:.1f} GB of moments, past the card's 80 GB), "
          f"remat; {TRAIN_B} x {TRAIN_S} tokens a step; init on the card "
          f"{secs:.2f} s")
    ckpt_root = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    res = train_loop(model, data, LoopConfig(
        total_steps=TRAIN_STEPS, ckpt_every=10**9, log_every=1), scfg,
        str(ckpt_root / "full"), params=params, device=dev)
    torch.cuda.synchronize()
    counts = _counts()
    ROUTE_COUNTS[label] = _route_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {k: per_step.get(k, 0) * TRAIN_STEPS for k in KERNELS}
    if counts != want:
        raise AssertionError(f"{label} launched {counts}; expected {want}")
    for name, by_route in ROUTE_COUNTS[label].items():
        if by_route != {"tensor_cores": counts[name], "cuda_cores": 0}:
            raise AssertionError(f"{label}: {name} launched {by_route} by "
                                 "route; every launch must take the tensor "
                                 "cores")
    if not all(math.isfinite(x) for x in res.losses + res.grad_norms) \
            or min(res.grad_norms) <= 0:
        raise AssertionError(f"{label}: losses {res.losses}, grad norms "
                             f"{res.grad_norms}")
    tps = TRAIN_B * TRAIN_S * (TRAIN_STEPS - 1) / (sum(res.step_ms[1:]) / 1e3)
    for i, (l, gn, ms) in enumerate(zip(res.losses, res.grad_norms,
                                        res.step_ms)):
        print(f"{label} step {i}: loss {l:.6f} grad_norm {gn:.6f} "
              f"{ms:.1f} ms")
    print(f"{label} main path: {TRAIN_STEPS} steps, {tps:.0f} tokens/s over "
          f"steps 1-{TRAIN_STEPS - 1}, peak memory {peak:.2f} GB "
          f"(max_memory_allocated); launches {counts}, by route "
          f"{ROUTE_COUNTS[label]}")
    batch = {"tokens": torch.from_numpy(synthetic_batch(
        data, TRAIN_STEPS)["tokens"]).to(dev)}
    step = build_train_step(model, scfg)
    opt = init_opt_state(params, scfg.opt)
    _breakdown(lambda: step(params, opt, batch),
               statistics.median(res.step_ms[1:]), f"{label} step")
    del params, opt, batch, step, model
    torch.cuda.empty_cache()
    summary = {"path": label, "tokens_per_step": TRAIN_B * TRAIN_S,
               "tokens_per_s": tps, "step_ms": res.step_ms,
               "losses": res.losses, "grad_norms": res.grad_norms,
               "peak_gb": peak, "opt_state_dtype": "bfloat16"}
    short = dataclasses.replace(cfg, n_layers=2)
    _train_card_vs_cpu(dev, short, seed, opt=MOE_OPT)
    _moe_ff_card_vs_cpu(dev, cfg, seed)
    _train_resume(dev, cfg, seed, ckpt_root, opt=MOE_OPT)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    _same_step_twice(dev, short, seed, MOE_OPT)
    torch.cuda.empty_cache()
    return {"moe_dispatch_bwd": record}, {label: counts}, summary


def _scan_bwd_row(dev, cfg, seed, reps, errs) -> dict:
    """The scan's backward at the chunk the path scans, (4, 256, d_inner,
    d_state) float32, from a given state and with the last state's
    gradient, from the forward's saved states: against its plain version
    (which recomputes every state), two calls bit for bit, the Function's
    gradient the direct call's bit for bit, then timed. The bound: dA and
    dBx read and d(dA) and d(dBx) written once (16 bytes an element), Cm,
    dy, h0 and dh_last read and dCm and dh0 written; the design's own
    traffic (the saved states besides, 4 / STATE_EVERY bytes an element)
    is printed beside it."""
    g = torch.Generator(dev).manual_seed(seed)
    shape = (TRAIN_B, cfg.ssm_chunk, cfg.ssm_d_inner, cfg.ssm_d_state)
    B, S, d, n = shape
    dA, dBx, Cm = _scan_inputs(g, dev, shape, torch.float32)
    h0 = torch.randn(B, d, n, generator=g, device=dev)
    dy = torch.randn(B, S, d, generator=g, device=dev)
    dh = torch.randn(B, d, n, generator=g, device=dev)
    states = torch.empty(ss.states_shape(*shape), device=dev)
    ss.selective_scan(dA, dBx, Cm, h0.clone(), states)
    args = (dA, dBx, Cm, h0, dy, dh, states)
    got = sb.selective_scan_bwd(*args)
    msg = _bwd_check("selective_scan_bwd", got,
                     sb.selective_scan_bwd_plain(*args[:6]), torch.float32,
                     errs, ("d(dA)", "d(dBx)", "dCm", "dh0"))
    again = sb.selective_scan_bwd(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    leaves_ = [t.detach().clone().requires_grad_() for t in (dA, dBx, Cm, h0)]
    torch.autograd.backward(sb.SelectiveScan.apply(*leaves_), (dy, dh))
    fn_same = all(torch.equal(t.grad, a) for t, a in zip(leaves_, got))
    print(f"check selective_scan_bwd {shape} float32 from a state and the "
          f"forward's states vs plain, largest relative error {msg} (tol "
          f"{BWD_TOL[torch.float32]}); two calls bit for bit equal: {same}; "
          f"the Function's gradient the direct call's bit for bit: "
          f"{fn_same}")
    if not (same and fn_same):
        raise AssertionError("selective_scan_bwd: two calls or the "
                             "Function's gradient differ")
    del got, leaves_
    el = dA.numel()
    small = Cm.numel() * 2 + dy.numel() + 3 * h0.numel()
    row = _kernel_row(
        "selective_scan_bwd", f"{shape} float32 with h0, dh_last",
        lambda: sb.selective_scan_bwd(*args),
        lambda: sb.selective_scan_bwd_plain(*args[:6]), None,
        4 * (4 * el + small), 8 * el, F32_OPS_PER_S, reps,
        f"{_count(cfg, 'mamba') * math.ceil(TRAIN_S / S)} a step",
        batch=3, calls=6)
    design_ms = (4 * (4 * el + small) + 4 * states.numel()) \
        / HBM_BYTES_PER_S * 1e3
    W = -(-d // sb.cta_channels(n))
    red_bytes = 4 * (B * W * S * n + Cm.numel())
    dc = {"device_ms": next((v for k, v in row["device_ms_by_kernel"].items()
                             if "dc_reduce" in k), None),
          "bound_ms": red_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
          "bytes": red_bytes}
    print(f"selective_scan_bwd: the design's traffic (16 + "
          f"{4 / ss.STATE_EVERY:g} bytes an element, the states read once) "
          f"{design_ms:.4f} ms at 3.35 TB/s; its dC reduce ({W} CTAs' "
          f"partials a (b, t, k)): device {dc['device_ms']} ms, bound "
          f"{dc['bound_ms']:.4f} ms by bytes")
    return {**row, "max_abs_err": errs["selective_scan_bwd"],
            "shape": list(shape), "design_bytes_ms": design_ms,
            "state_every": ss.STATE_EVERY, "dc_reduce": dc}


def _mamba_block_card_vs_cpu(dev, sm, seed) -> None:
    """The smoke config's first mamba mixer in float32 on the card
    (kernels) and on the CPU (plain versions): its output and every
    leaf's and x's gradient through the chunked scan (S 40, chunks of 16
    and a ragged 8), at TRAIN_GRAD_TOL, as tests/test_torch_ssm.py holds
    it to the reference."""
    from repro_torch.models import ssm as SSM
    model = get_model(sm)
    params = init_params(model.blueprint(), torch.Generator().manual_seed(
        seed))
    k = [kind.mixer for kind in model.period].index("mamba")
    p = {n: v[0].float() for n, v in params["stack"][k]["mamba"].items()}
    gen = torch.Generator().manual_seed(seed + 4)
    x = torch.randn(2, 40, sm.d_model, generator=gen)
    w = torch.randn(2, 40, sm.d_model, generator=gen)
    out = {}
    for where in ("cpu", dev):
        ps = {n: v.detach().to(where, copy=True).requires_grad_()
              for n, v in p.items()}
        xs = x.detach().to(where, copy=True).requires_grad_()
        y = SSM.mamba_scan_chunked(ps, xs, d_state=sm.ssm_d_state,
                                   chunk=sm.ssm_chunk)
        (y * w.to(where)).sum().backward()
        out[str(where)] = (y.detach().cpu(), {
            **{n: v.grad.cpu() for n, v in ps.items()}, "x": xs.grad.cpu()})
    (y_cpu, g_cpu), (y_card, g_card) = out["cpu"], out[str(dev)]
    ey = _rel(y_card, y_cpu)
    errs = {n: float((g_card[n] - g_cpu[n]).norm()
                     / g_cpu[n].norm().clamp_min(1e-30)) for n in g_cpu}
    print(f"check {sm.name} mamba mixer (d {sm.d_model}, d_inner "
          f"{sm.ssm_d_inner}, d_state {sm.ssm_d_state}) float32 card vs "
          f"cpu: output relative error {ey:.3g}; gradient relative L2 "
          f"errors " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
          + f" (tol {TRAIN_GRAD_TOL})")
    if ey > BWD_TOL[torch.float32] or max(errs.values()) > TRAIN_GRAD_TOL:
        raise AssertionError("mamba mixer: card against cpu past tolerance")


def hybrid_train_phase(dev, seed: int, reps: int):
    """jamba-1.5-large-398b's gradient at full width, cut to two layers:
    the scan's backward checked and timed at a chunk's shape, the expert
    FF's backward checked on a slice of the experts and timed over all,
    then HYBRID_GRAD_STEPS calls of ``value_and_grad`` on 4 x 2048 tokens
    (counted; no AdamW), and the smoke period's loss card vs CPU with its
    mamba mixer's gradients block by block in float32. Returns the
    records, the counts of the path and the calls' numbers."""
    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, **HYBRID_TRAIN_CUT)
    label = f"{cfg.name}/train"
    reduced = {k: [getattr(full, k), v] for k, v in HYBRID_TRAIN_CUT.items()}
    print(f"{HYBRID_ARCH} gradient on one card: reduced "
          f"{json.dumps(reduced)}; every width as published")
    errs: dict = {}
    records = {"selective_scan_bwd": _scan_bwd_row(dev, cfg, seed,
                                                   min(reps, 10), errs)}
    torch.cuda.empty_cache()
    g = torch.Generator(dev).manual_seed(seed + 1)
    wi, wo = _expert_weights(g, dev, cfg.moe_experts, cfg.d_model,
                             cfg.moe_d_ff)
    _expert_bwd_check(g, dev, cfg, wi, wo, errs,
                      experts=JAMBA_CHECK_EXPERTS)
    per_call = _train_launches(cfg)
    records["moe_dispatch_bwd"] = _expert_bwd_rows(
        dev, cfg, wi, wo, min(reps, 3), errs,
        f"{per_call['moe_dispatch_bwd']} a gradient step", batch=1,
        plain_experts=JAMBA_CHECK_EXPERTS)
    del wi, wo
    torch.cuda.empty_cache()

    model, params = _init(dev, cfg, seed)
    n = count_params(model.blueprint())
    print(f"{label}: value_and_grad only, no AdamW: its moments would add "
          f"{n * 4 / 1e9:.1f} GB beside the {n * 4 / 1e9:.1f} GB of bf16 "
          f"params and grads; loss_chunk {cfg.loss_chunk}, remat")
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (TRAIN_B, TRAIN_S),
        generator=torch.Generator(dev).manual_seed(seed + 2), device=dev)}
    losses, norms, ms = [], [], []

    def steps():
        for _ in range(HYBRID_GRAD_STEPS):
            (loss, grads), secs = _sync_s(lambda: value_and_grad(
                model, params, batch, remat=True))
            ms.append(secs * 1e3)
            losses.append(float(loss))
            norms.append(float(torch.stack([
                torch.linalg.vector_norm(t, dtype=torch.float32)
                for t in leaves(grads)]).norm()))
            del grads

    torch.cuda.reset_peak_memory_stats()
    _, _, counts = _counted(steps, label, {
        k: v * HYBRID_GRAD_STEPS for k, v in per_call.items()})
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses + norms) or min(norms) <= 0:
        raise AssertionError(f"{label}: losses {losses}, grad norms {norms}")
    for i, (l, gn, t) in enumerate(zip(losses, norms, ms)):
        print(f"{label} gradient step {i}: loss {l:.6f} grad_norm {gn:.6f} "
              f"{t:.1f} ms")
    tps = TRAIN_B * TRAIN_S * (HYBRID_GRAD_STEPS - 1) / (sum(ms[1:]) / 1e3)
    print(f"{label}: {HYBRID_GRAD_STEPS} gradient steps, {tps:.0f} tokens/s "
          f"over steps 1-{HYBRID_GRAD_STEPS - 1}, peak memory {peak:.2f} GB "
          "(max_memory_allocated)")
    _breakdown(lambda: value_and_grad(model, params, batch, remat=True),
               statistics.median(ms[1:]), f"{label} gradient step")
    del params, batch, model
    torch.cuda.empty_cache()
    summary = {"path": label, "tokens_per_step": TRAIN_B * TRAIN_S,
               "tokens_per_s": tps, "step_ms": ms, "losses": losses,
               "grad_norms": norms, "peak_gb": peak, "optimizer": None,
               "reduced": reduced}

    # the smoke config's period on the card against the CPU (widths cut:
    # the CPU would need 48 GB at full width), routers zeroed
    sm = get_config(HYBRID_ARCH, smoke=True)
    sm = dataclasses.replace(sm, n_layers=len(sm.layer_pattern()))
    cg = torch.Generator().manual_seed(seed)
    _train_card_vs_cpu(dev, sm, seed, batch={"tokens": torch.randint(
        0, sm.vocab, (2, 40), generator=cg)}, label="one smoke period",
        adamw=False, grads=False)
    _mamba_block_card_vs_cpu(dev, sm, seed)
    return records, {label: counts}, summary


# --------------------------------------------------------------------------
# the encoder-decoder and the VLM: seamless-m4t-large-v2 at full width and
# depth (serving and training), qwen2-vl-72b's one-layer cut (training)
# --------------------------------------------------------------------------

ENCDEC_ARCH, VLM_ARCH = "seamless-m4t-large-v2", "qwen2-vl-72b"
#: qwen2-vl on one card: every width, one layer (80 layers are 72 B
#: params)
VLM_CUT = {"n_layers": 1}
#: the encoder's source frames at serving: 8 slots of 2048 positions
ENC_B, ENC_S = SERVE_SLOTS, 2048
#: the cross-attention routes a card run holds, (B, H, Hkv, Sq, Sk, D):
#: the encoder (non-causal, Sq = Sk), cross-attention in training
#: (S_tgt 2048 against S_src 1500), at decode (one query row against 2048
#: source positions at 8 slots) and at qwen2-vl's head dim 128 (not timed)
CROSS_FWD = {"encoder": (4, 16, 16, 2048, 2048, 64),
             "cross_train": (4, 16, 16, 2048, 1500, 64),
             "cross_decode": (8, 16, 16, 1, 2048, 64),
             "cross_decode_d128": (8, 64, 8, 1, 4096, 128)}
CROSS_BWD = (4, 16, 16, 2048, 1500, 64)
#: the VLM's image: 16 x 16 patches, 256 frames (the reference's
#: min(256, S))
VLM_GRID = (16, 16)


def _cross_qkv(g, dev, B, H, Hkv, Sq, Sk, D):
    return tuple(torch.randn(B, S, h, D, generator=g, device=dev)
                 .bfloat16().transpose(1, 2)
                 for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))


def _sdpa(q, k, v, causal=False):
    return F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])


def cross_kernel_checks(dev, seed, reps, launches) -> tuple:
    """The encoder-decoder's attention routes on the tensor cores against
    their plain versions at FA_TOL (the lse at 1e-5) and BWD_TOL, each
    (but D 128's) timed beside SDPA: returns the forward rows by route
    and the backward's row, with their max abs errors."""
    g = torch.Generator(dev).manual_seed(seed + 22)
    rtol, atol = FA_TOL[torch.bfloat16]
    fwd = {}
    for name, (B, H, Hkv, Sq, Sk, D) in CROSS_FWD.items():
        q, k, v = _cross_qkv(g, dev, B, H, Hkv, Sq, Sk, D)
        way = fa.route(torch.bfloat16, D, fa._rows_aligned(q, k, v))
        if way != "tensor_cores":
            raise AssertionError(f"flash_attention {name}: route {way}")
        got, lse = fa.flash_attention(q, k, v, causal=False, with_lse=True)
        want, want_lse = fa.flash_attention_plain(q, k, v, causal=False,
                                                  with_lse=True)
        e = _compare(f"flash_attention {name}", {"o": got}, {"o": want},
                     rtol, atol)
        e_lse = _rel(lse, want_lse)
        if e_lse > 1e-5:
            raise AssertionError(f"flash_attention {name}: lse {e_lse}")
        print(f"check flash_attention {name} ({B}, {H}, {Sq}, {D}) against "
              f"{Sk} keys, kv heads {Hkv}, non-causal bf16 ({way}) vs plain "
              f"max abs err {e:.3g} (rtol {rtol}, atol {atol}; median |o| "
              f"{float(want.float().abs().median()):.3g}); lse relative "
              f"error {e_lse:.3g}")
        if name != "cross_decode_d128":
            nbytes = 2 * (2 * B * H * Sq * D + 2 * B * Hkv * Sk * D)
            row = _kernel_row(
                "flash_attention", f"({B}, {H}, {Sq}, {D}) x {Sk} keys "
                "non-causal bf16",
                lambda: fa.flash_attention(q, k, v, causal=False),
                lambda: fa.flash_attention_plain(q, k, v, causal=False),
                lambda: _sdpa(q, k, v), nbytes, 4 * B * H * D * Sq * Sk,
                BF16_OPS_PER_S, reps, launches[name])
            fwd[name] = {**row, "max_abs_err": e, "shape": [B, H, Hkv, Sq,
                                                            Sk, D]}
        del q, k, v, got, want, lse, want_lse
    B, H, Hkv, Sq, Sk, D = CROSS_BWD
    q, k, v = _cross_qkv(g, dev, B, H, Hkv, Sq, Sk, D)
    do = torch.randn(B, Sq, H, D, generator=g, device=dev).bfloat16() \
        .transpose(1, 2)
    o, lse = fa.flash_attention(q, k, v, causal=False, with_lse=True)
    errs: dict = {}
    for scale in (1.0, TRAIN_DO_SCALE):
        d = (do.float() * scale).bfloat16() if scale != 1.0 else do
        got = fb.flash_attention_bwd(q, k, v, o, d, lse, causal=False)
        msg = _bwd_check("flash_attention_bwd", got,
                         fb.flash_attention_bwd_plain(q, k, v, o, d, lse,
                                                      causal=False),
                         torch.bfloat16, errs, ("dq", "dk", "dv"))
        again = fb.flash_attention_bwd(q, k, v, o, d, lse, causal=False)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("flash_attention_bwd non-causal: two "
                                 "calls differ")
        print(f"check flash_attention_bwd ({B}, {H}, {Sq}, {D}) against "
              f"{Sk} keys non-causal bf16 do x {scale:.6g} "
              f"({fb.route(torch.bfloat16, D)}) vs plain, largest "
              f"relative error {msg} (tol {BWD_TOL[torch.bfloat16]}); two "
              f"calls bit for bit equal")
    nbytes = 2 * (4 * B * H * Sq * D + 4 * B * Hkv * Sk * D) + 4 * B * H * Sq
    row = _kernel_row(
        "flash_attention_bwd", f"({B}, {H}, {Sq}, {D}) x {Sk} keys "
        "non-causal bf16",
        lambda: fb.flash_attention_bwd(q, k, v, o, do, lse, causal=False),
        lambda: fb.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                             causal=False),
        _backward_only(_sdpa, (q, k, v), do), nbytes,
        2 * 5 * B * H * D * Sq * Sk, BF16_OPS_PER_S, min(reps, 5),
        launches["bwd"], batch=3, calls=6)
    bwd = {**row, "max_abs_err": errs["flash_attention_bwd"],
           "shape": [B, H, Hkv, Sq, Sk, D]}
    return fwd, bwd


def _counted(fn, label, want):
    """``fn()`` with the counts set to 0 just before and read just after:
    every kernel of ``want`` launched exactly that often, none other, and
    every flash_attention and flash_attention_bwd launch on the tensor
    cores; returns (its result, its wall s, the counts)."""
    _zero_counts()
    out, secs = _sync_s(fn)
    counts = _counts()
    ROUTE_COUNTS[label] = routes = _route_counts()
    full = {k: want.get(k, 0) for k in KERNELS}
    if counts != full:
        raise AssertionError(f"{label} launched {counts}; expected {full}")
    for name, by_route in routes.items():
        if by_route != {"tensor_cores": counts[name], "cuda_cores": 0}:
            raise AssertionError(f"{label}: {name} launched {by_route} by "
                                 "route; every launch must take the tensor "
                                 "cores")
    print(f"{label}: launches {counts}, by route {routes}; {secs:.3f} s")
    return out, secs, counts


def _train_steps(model, params, batch, scfg, label, per_step, tokens):
    """TRAIN_STEPS steps of ``build_train_step`` on the card (counted),
    then one step's breakdown (uncounted): returns the summary."""
    step = build_train_step(model, scfg)
    opt = init_opt_state(params, scfg.opt)
    torch.cuda.reset_peak_memory_stats()
    ms, mets = [], []

    def steps():
        for _ in range(TRAIN_STEPS):
            (_, _, m), s = _sync_s(lambda: step(params, opt, batch))
            ms.append(s * 1e3)
            mets.append(m)

    _, _, counts = _counted(steps, label, {k: v * TRAIN_STEPS
                                           for k, v in per_step.items()})
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in mets]
    norms = [float(m["grad_norm"]) for m in mets]
    if not all(math.isfinite(x) for x in losses + norms) or min(norms) <= 0:
        raise AssertionError(f"{label}: losses {losses}, grad norms {norms}")
    tps = tokens * (TRAIN_STEPS - 1) / (sum(ms[1:]) / 1e3)
    for i, (l, gn, t) in enumerate(zip(losses, norms, ms)):
        print(f"{label} step {i}: loss {l:.6f} grad_norm {gn:.6f} {t:.1f} ms")
    print(f"{label}: {TRAIN_STEPS} steps, {tps:.0f} tokens/s over steps "
          f"1-{TRAIN_STEPS - 1}, peak memory {peak:.2f} GB "
          f"(max_memory_allocated), microbatches {scfg.microbatches}")
    _breakdown(lambda: step(params, opt, batch), statistics.median(ms[1:]),
               f"{label} step")
    del opt
    return {"path": label, "tokens_per_step": tokens, "tokens_per_s": tps,
            "step_ms": ms, "losses": losses, "grad_norms": norms,
            "peak_gb": peak, "microbatches": scfg.microbatches}, counts


def encdec_phase(dev, seed: int, reps: int):
    """seamless-m4t-large-v2 at full width and depth: the cross routes
    checked and timed, then serving (the encoder over 8 x 2048 frames, a
    prefill of 4 x 2048 tokens, decode_step against the encoder's output
    at 8 slots, 64 teacher-forced steps against the decoder's forward)
    and TRAIN_STEPS train steps at the reference's split, each counted;
    a depth-2 step on the card against the CPU. Returns the kernels'
    rows, the counts by path and the train summary."""
    cfg = get_config(ENCDEC_ARCH)
    arch, L, E = cfg.name, cfg.n_layers, cfg.enc_layers
    fwd, bwd = cross_kernel_checks(dev, seed, reps, {
        "encoder": f"{E} an encoder call", "cross_train":
        f"{L} a train step forward", "cross_decode": f"{L} a decode step",
        "bwd": f"{L} a train step"})
    model, params = _init(dev, cfg, seed)
    g = torch.Generator(dev).manual_seed(seed)
    by_path = {}

    # serving: the encoder, prefill (no encoder: the reference's), decode
    frames = torch.randn(ENC_B, ENC_S, cfg.d_model, generator=g,
                         device=dev).bfloat16()
    enc, _, by_path[f"{arch}/encode"] = _counted(
        lambda: model._encode(params, frames), f"{arch}/encode",
        {"rmsnorm": 2 * E + 1, "flash_attention": E})
    if enc.shape != frames.shape or not torch.isfinite(enc.float()).all():
        raise AssertionError(f"encoder output {tuple(enc.shape)}")
    enc_s = statistics.median(_sync_s(lambda: model._encode(params, frames))
                              [1] for _ in range(3))
    print(f"{arch} encoder {ENC_B} x {ENC_S} frames: {enc_s * 1e3:.1f} ms "
          f"(median of 3), {ENC_B * ENC_S / enc_s:.0f} frames/s")
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=g,
                         device=dev)
    logits, _, by_path[f"{arch}/prefill"] = _counted(
        lambda: model.prefill(params, toks), f"{arch}/prefill",
        {"rmsnorm": 2 * L + 1, "flash_attention": L})
    if logits.shape != (PREFILL_B, cfg.padded_vocab) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    pre_s = statistics.median(_sync_s(lambda: model.prefill(params, toks))[1]
                              for _ in range(3))
    print(f"{arch} prefill {PREFILL_B} x {PREFILL_S}: {pre_s * 1e3:.1f} ms "
          f"(median of 3), {PREFILL_B * PREFILL_S / pre_s:.0f} tokens/s")
    _breakdown(lambda: model.prefill(params, toks), pre_s * 1e3,
               f"{arch} prefill {PREFILL_B} x {PREFILL_S}")
    cache = model.init_cache(SERVE_SLOTS, SERVE_MAX_SEQ, device=dev)
    step_toks = torch.randint(0, cfg.vocab, (SERVE_SLOTS, 1), generator=g,
                              device=dev)
    step_pos = torch.full((SERVE_SLOTS,), 100, device=dev)

    def step():
        return model.decode_step(params, cache, step_toks, step_pos, enc)

    (logits, _), _, by_path[f"{arch}/decode"] = _counted(
        step, f"{arch}/decode", {"rmsnorm": 3 * L + 1, "flash_attention": L})
    if logits.shape != (SERVE_SLOTS, 1, cfg.padded_vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"decode logits {tuple(logits.shape)}")
    step_ms = statistics.median(_sync_s(step)[1] for _ in range(10)) * 1e3
    print(f"{arch} decode_step {SERVE_SLOTS} slots against {ENC_S} source "
          f"positions, cache {SERVE_MAX_SEQ}: {step_ms:.2f} ms (median of "
          f"10), {SERVE_SLOTS / step_ms * 1e3:.1f} tokens/s")
    _breakdown(step, step_ms, f"{arch} decode_step {SERVE_SLOTS} slots")

    # teacher-forced decode against the decoder's forward, one sequence
    prompt, enc1 = toks[:1, :DECODE_T], enc[:1]
    full = model._decoder_forward(params, prompt, enc1)[0, :, :cfg.vocab]
    c1 = model.init_cache(1, DECODE_T, device=dev)
    got = torch.cat([model.decode_step(
        params, c1, prompt[:, t:t + 1], torch.full((1,), t, device=dev),
        enc1)[0][0, :, :cfg.vocab] for t in range(DECODE_T)])
    rtol, atol = ROUTED_APART_TOL
    worst = float((got - full).abs().max())
    ok = torch.allclose(got, full, rtol=rtol, atol=atol)
    print(f"check {arch} decode ({DECODE_T} teacher-forced steps against "
          f"the encoder) vs the decoder's forward, every position: max abs "
          f"err {worst:.3g} (rtol {rtol}, atol {atol}; logits std "
          f"{float(full.std()):.3g}): {'ok' if ok else 'past it'}")
    if not ok:   # ROADMAP C15: held layer by layer, as xlstm's
        e, scale = _layers_decode_vs_forward(dev, model, params,
                                             prompt, enc1)
        print(f"check {arch} decode vs forward layer by layer: each of "
              f"{L} layers within {XLSTM_LAYER_TOL} (largest |diff| "
              f"{e:.3g}, largest |residual| {scale:.3g})")
    del cache, c1, logits, enc, frames, full, got

    # training at the reference's split: 4 x 2048 tokens, 4 x 2048 frames
    tg = torch.Generator(dev).manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S),
                                     generator=tg, device=dev),
             "frontend_embeds": torch.randn(TRAIN_B, TRAIN_S, cfg.d_model,
                                            generator=tg, device=dev)
             .bfloat16()}
    fwd_rms, fwd_fa = (2 * E + 1) + (3 * L + 1), E + 2 * L
    remat = {"rmsnorm": 2 * E + 3 * L, "flash_attention": E + 2 * L}
    summary, by_path[f"{arch}/train"] = _train_steps(
        model, params, batch, StepConfig(remat=True, opt=AdamWConfig()),
        f"{arch}/train", {"rmsnorm": fwd_rms + remat["rmsnorm"],
                          "flash_attention": fwd_fa + remat[
                              "flash_attention"],
                          "rmsnorm_bwd": fwd_rms,
                          "flash_attention_bwd": fwd_fa},
        TRAIN_B * TRAIN_S)
    del params, batch, model
    torch.cuda.empty_cache()
    # depth 2 card against cpu, half as many frames as tokens (C16)
    cg = torch.Generator().manual_seed(seed)
    short = dataclasses.replace(cfg, n_layers=2, enc_layers=2)
    _train_card_vs_cpu(dev, short, seed, batch={
        "tokens": torch.randint(0, cfg.vocab, (1, 256), generator=cg),
        "frontend_embeds": torch.randn(1, 128, cfg.d_model,
                                       generator=cg).bfloat16()},
        label="decoder and encoder depth 2, 128 frames")
    torch.cuda.empty_cache()
    return {"flash_attention": fwd, "flash_attention_bwd": bwd}, by_path, \
        summary


def vlm_phase(dev, seed: int, reps: int):
    """qwen2-vl-72b cut to one layer at full width: TRAIN_STEPS train
    steps (counted) with 256 patch embeddings and M-RoPE positions laid
    out as Qwen2-VL does; its step against the CPU's on a short batch
    (the loss and every leaf's gradient)."""
    cfg = dataclasses.replace(get_config(VLM_ARCH), **VLM_CUT)
    arch = cfg.name
    print(f"qwen2-vl cut for one card: n_layers 80 -> {cfg.n_layers}")
    model, params = _init(dev, cfg, seed)
    tg = torch.Generator(dev).manual_seed(seed + 2)
    gh, gw = VLM_GRID
    batch = {"tokens": torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S),
                                     generator=tg, device=dev),
             "frontend_embeds": torch.randn(TRAIN_B, gh * gw, cfg.d_model,
                                            generator=tg, device=dev)
             .bfloat16(),
             "mrope_positions": mrope_grid_positions(TRAIN_B, TRAIN_S, gh,
                                                     gw, device=dev)}
    L = cfg.n_layers
    summary, counts = _train_steps(
        model, params, batch, StepConfig(remat=True, opt=AdamWConfig()),
        f"{arch}/train", {"rmsnorm": (2 * L + 1) + 2 * L,
                          "flash_attention": 2 * L,
                          "rmsnorm_bwd": 2 * L + 1,
                          "flash_attention_bwd": L}, TRAIN_B * TRAIN_S)
    del params, batch, model
    torch.cuda.empty_cache()
    cg = torch.Generator().manual_seed(seed)
    _train_card_vs_cpu(dev, cfg, seed, batch={
        "tokens": torch.randint(0, cfg.vocab, (1, 64), generator=cg),
        "frontend_embeds": torch.randn(1, 16, cfg.d_model,
                                       generator=cg).bfloat16(),
        "mrope_positions": mrope_grid_positions(1, 64, 4, 4)},
        label="depth 1, 16 patches", adamw=False)
    torch.cuda.empty_cache()
    return {f"{arch}/train": counts}, summary


# --------------------------------------------------------------------------
# distribution: several ranks as processes that share the one card
# --------------------------------------------------------------------------

#: GPipe: granite at full width and depth, 40 layers in 4 stages of 10, 4
#: microbatches of 1 x 2048 embedded tokens
GPIPE_STAGES, GPIPE_M, GPIPE_S = 4, 4, 2048
#: the sharded train step: mesh (data 2, model 2), full width cut to 2
#: layers, one step of 4 x 2048 tokens (then one more, timed)
TP_MESH, TP_CUT, TP_B, TP_S = (2, 2), {"n_layers": 2}, 4, 2048
#: the sharded decode: 8 slots, 6 steps, a cache a multiple of 3 and 4
#: long; on (1, 4) granite's 8 kv heads shard, on (1, 3) nothing divides
#: 3 and the cache is sequence-sharded
DEC_MESHES, DEC_SLOTS, DEC_STEPS, DEC_LEN = ((1, 4), (1, 3)), 8, 6, 384
#: jamba's sharded train step on TP_MESH and decode on (1, 4): full width
#: cut to a mamba layer and an attention layer, each with the dense FF
#: (no MoE: olmoe's tp_train holds MoE under a context), 2.85 B params
HYBRID_TP_CUT = {"n_layers": 2, "attn_every_k": 2, "moe_experts": 0}
#: xlstm's sharded decode and prefill on (1, 4): one period at full width
#: (1 sLSTM, 7 mLSTM layers; one head a rank), a prefill of 1 x 512
XLSTM_TP_CUT, XLSTM_TP_PREFILL = {"n_layers": 8}, 512
#: xlstm's sharded decode and prefill in float32 against one process's in
#: float32 (``_float32_lm``), max abs err on the logits: the same sums in
#: another order (the CPU tests' F32_TOL)
XLSTM_F32_ATOL = 1e-3
RECURRENT_MESH = (1, 4)
DIST_TIMEOUT_S = 300


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_counts(fn):
    """``fn()`` on this rank with the counts set to 0 just before and read
    just after -> (its result, its wall s, counts, counts by route)."""
    _zero_counts()
    out, secs = _sync_s(fn)
    return out, secs, _counts(), _route_counts()


def _gpipe_rank(dev, seed, rank):
    """One stage of the GPipe pipeline (rank 0: also the one-process run
    of the 40 layers, microbatch by microbatch, held against it)."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.pipeline import (bubble_share,
                                                  make_pipelined_apply)
    from repro_torch.launch.mesh import make_mesh
    cfg = get_config(LM_ARCH)
    model = get_model(cfg)
    params = init_params(model.blueprint(),
                         torch.Generator(dev).manual_seed(seed))
    P, L = GPIPE_STAGES, cfg.n_layers
    staged = tree_map(lambda a: a.view((P, L // P) + a.shape[1:]),
                      params["stack"])
    g = torch.Generator(dev).manual_seed(seed + 3)
    xs = torch.randn(GPIPE_M, 1, GPIPE_S, cfg.d_model, generator=g,
                     device=dev).bfloat16()
    pos = torch.arange(GPIPE_S, device=dev)[None, :]

    def layer_fn(stage_params, x):
        return model._run_stack(stage_params, x, pos, kinds=model.period,
                                causal=True)[0]

    mesh = make_mesh((P,), ("pipe",), dev)
    apply = make_pipelined_apply(mesh, layer_fn, GPIPE_M)
    col.reset()
    ys, secs, counts, routes = _rank_counts(lambda: apply(staged, xs))
    staged_bytes = dict(col.STAGED)
    _, secs2 = _sync_s(lambda: apply(staged, xs))
    out = {"counts": counts, "routes": routes, "ms": secs * 1e3,
           "ms_again": secs2 * 1e3, "staged": staged_bytes,
           "bubble": bubble_share(P, GPIPE_M),
           "finite": bool(torch.isfinite(ys.float()).all())}
    if rank == 0:
        want = torch.stack([layer_fn(params["stack"], xs[m])
                            for m in range(GPIPE_M)])
        out["max_abs_err"] = float((ys.float() - want.float()).abs().max())
        out["ok"] = bool(torch.equal(ys, want))
        out["scale"] = float(want.float().abs().max())
    return out


def _tp_train_rank(dev, seed, rank, arch):
    """One rank's sharded train step on TP_MESH (rank 0: also the
    one-process step on the same params and batch, held against it)."""
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import (jit_train_step, make_step_ctx,
                                              shard_batch)
    cfg = dataclasses.replace(get_config(arch), **TP_CUT)
    model = get_model(cfg)
    mesh = make_mesh(TP_MESH, ("data", "model"), dev)

    def fresh():
        p = init_params(model.blueprint(), torch.Generator(dev).manual_seed(
            seed))
        _zero_routers(p)
        return p

    tg = torch.Generator(dev).manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (TP_B, TP_S),
                                     generator=tg, device=dev)}
    opt = MOE_OPT if cfg.moe_experts else AdamWConfig()
    scfg = StepConfig(remat=True, opt=opt)
    step, (_, _, bsh) = jit_train_step(model, mesh, scfg, "train_4k")
    ctx = make_step_ctx(model, mesh, "train_4k")
    full = fresh()
    lp = ctx.shard_tree(full)
    del full
    lo = init_opt_state(lp, opt)
    lb = shard_batch(batch, ctx, bsh)
    torch.cuda.reset_peak_memory_stats()
    col.reset()
    (lp, lo, met), secs, counts, routes = _rank_counts(
        lambda: step(lp, lo, lb))
    staged_bytes = dict(col.STAGED)
    coll = col.counters()
    # the gradients, sharded and whole, of every leaf: one AdamW step at
    # the warmup's first lr (3e-6) moves a bf16 weight by less than its
    # ulp, so the params after it barely see the gradient; the gradients
    # and the grad norm are what hold the sharded backward
    smodel = model.sharded(ctx)
    gp = ctx.shard_tree(fresh())
    _, sg = value_and_grad(smodel, gp, lb, remat=True,
                           scale=1.0 / ctx.size(ctx.axes))
    sg = ctx.unshard_tree(ctx.sum_replicas(sg))
    whole = ctx.unshard_tree(lp)
    out = {"counts": counts, "routes": routes, "first_ms": secs * 1e3,
           "staged": staged_bytes, "collectives": coll,
           "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])}
    if rank == 0:
        p1 = fresh()
        from_zero = {n for n, a in zip(_leaf_names(p1), leaves(p1))
                     if not a.float().any()}
        o1 = init_opt_state(p1, opt)
        _zero_counts()
        p1, o1, m1 = build_train_step(model, scfg)(p1, o1, batch)
        _, g1 = value_and_grad(model, fresh(), batch, remat=True)
        names = _leaf_names(p1)

        def rel(a, b):
            return float((a.float() - b.float()).norm()
                         / b.float().norm().clamp_min(1e-30))
        out["loss_one"] = float(m1["loss"])
        out["grad_norm_one"] = float(m1["grad_norm"])
        out["perr"] = {n: rel(a, b) for n, a, b in
                       zip(names, leaves(whole), leaves(p1))
                       if n not in from_zero}
        out["gerr"] = {n: rel(a, b) for n, a, b in
                       zip(names, leaves(sg), leaves(g1))
                       if b.float().any()}
        out["zero_grads"] = sorted(
            n for n, b in zip(names, leaves(g1)) if not b.float().any())
        out["zero_grads_sharded"] = sorted(
            n for n, a in zip(names, leaves(sg)) if not a.float().any())
        del p1, o1, g1
    del whole, sg, gp
    torch.cuda.synchronize()
    _, secs2 = _sync_s(lambda: step(lp, lo, lb))
    out["step_ms"] = secs2 * 1e3
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _tp_decode_rank(dev, seed, rank, shape):
    """DEC_STEPS sharded decode steps of granite cut to 2 layers on a mesh
    (1, n) (rank 0: also the one-process decode_step, held against
    them)."""
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.blueprint import PSpec
    from repro_torch.train.train_step import jit_decode_step, make_step_ctx
    cfg = dataclasses.replace(get_config(LM_ARCH), **TP_CUT)
    model = get_model(cfg)
    mesh = make_mesh(shape, ("data", "model"), dev)
    params = init_params(model.blueprint(),
                         torch.Generator(dev).manual_seed(seed))
    step, (_, bsh) = jit_decode_step(model, mesh, "decode_32k")
    ctx = make_step_ctx(model, mesh, "decode_32k")
    lp = ctx.shard_tree(params)
    cache = model.init_cache(DEC_SLOTS, DEC_LEN, device=dev)
    lcache = tree_map(lambda t, sp: ctx.shard(t, sp).clone(), cache,
                      bsh["cache"])
    g = torch.Generator(dev).manual_seed(seed + 4)
    toks = torch.randint(0, cfg.vocab, (DEC_SLOTS, DEC_STEPS), generator=g,
                         device=dev)
    vspec = PSpec(ctx.batch or None, None,
                  "model" if ctx.logical("vocab") else None)
    col.reset()

    def steps():
        outs = []
        for t in range(DEC_STEPS):
            pos = torch.full((DEC_SLOTS,), t, device=dev)
            lb = {"tokens": ctx.shard(toks[:, t:t + 1], bsh["tokens"]),
                  "pos": ctx.shard(pos, bsh["pos"]), "cache": lcache}
            outs.append(ctx.unshard(step(lp, lb)[0], vspec))
        return outs

    got, secs, counts, routes = _rank_counts(steps)
    out = {"counts": counts, "routes": routes, "ms": secs * 1e3 / DEC_STEPS,
           "staged": dict(col.STAGED), "seq": list(ctx.seq),
           "cache_spec": list(map(str, bsh["cache"][0]["k"]))}
    if rank == 0:
        rc = model.init_cache(DEC_SLOTS, DEC_LEN, device=dev)
        err = 0.0
        for t in range(DEC_STEPS):
            want, _ = model.decode_step(params, rc, toks[:, t:t + 1],
                                        torch.full((DEC_SLOTS,), t,
                                                   device=dev))
            err = max(err, float((got[t] - want).abs().max()))
        out["max_abs_err"] = err
    return out


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def _noisy_embed(params):
    """params with a tenth of the embedding's entries one bf16 ulp up:
    ROADMAP C15's yardstick of how far bf16 noise moves a result."""
    e = params["embed"].clone()
    g = torch.Generator(e.device).manual_seed(0)
    mask = torch.rand(e.shape, generator=g, device=e.device) < 0.1
    e[mask] = (e[mask].float() * (1 + 2 ** -8)).bfloat16()
    return {**params, "embed": e}


def _tp_train_hybrid_rank(dev, seed, rank):
    """jamba's sharded train step on TP_MESH at HYBRID_TP_CUT (rank 0:
    the one-process loss, grad norm and gradients on the same params and
    batch, and the one-process gradients from ``_noisy_embed``'s params,
    C15's yardstick). The sharded gradients are gathered and compared a
    leaf at a time: no rank holds two whole trees."""
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import (jit_train_step, make_step_ctx,
                                              shard_batch)
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), **HYBRID_TP_CUT)
    model = get_model(cfg)
    mesh = make_mesh(TP_MESH, ("data", "model"), dev)

    def fresh():
        return init_params(model.blueprint(),
                           torch.Generator(dev).manual_seed(seed))

    tg = torch.Generator(dev).manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (TP_B, TP_S),
                                     generator=tg, device=dev)}
    scfg = StepConfig(remat=True, opt=AdamWConfig())
    step, (_, _, bsh) = jit_train_step(model, mesh, scfg, "train_4k")
    ctx = make_step_ctx(model, mesh, "train_4k")
    lp = ctx.shard_tree(fresh())
    lo = init_opt_state(lp, scfg.opt)
    lb = shard_batch(batch, ctx, bsh)
    torch.cuda.reset_peak_memory_stats()
    col.reset()
    # one step, timed: the kernels are warm from the phase's earlier
    # parts, and a second step would add 12 s of gloo for the same time
    (lp, lo, met), secs, counts, routes = _rank_counts(
        lambda: step(lp, lo, lb))
    coll = col.counters()
    del lp, lo
    _, sg = value_and_grad(model.sharded(ctx), ctx.shard_tree(fresh()), lb,
                           remat=True, scale=1.0 / ctx.size(ctx.axes))
    sg = ctx.sum_replicas(sg)
    out = {"counts": counts, "routes": routes, "step_ms": secs * 1e3,
           "staged": dict(col.STAGED), "collectives": coll,
           "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])}
    if rank == 0:
        p1 = fresh()
        loss1, g1 = value_and_grad(model, p1, batch, remat=True)
        _, gn = value_and_grad(model, _noisy_embed(p1), batch, remat=True)
        del p1
        out["loss_one"] = float(loss1)
        out["grad_norm_one"] = float(global_norm(g1))
        out["grad_norm_noise"] = abs(float(global_norm(gn))
                                     / out["grad_norm_one"] - 1)
        g1, gn = leaves(g1), leaves(gn)
        out["gerr"], out["noise"] = {}, {}
    names = _leaf_names(sg)
    blocks = [l.blocks for l in leaves(ctx.bp)]
    with torch.no_grad():
        for i, (g, spec) in enumerate(zip(leaves(sg), leaves(ctx.specs))):
            whole = ctx.unshard(g, spec, blocks[i])
            if rank == 0 and g1[i].float().any():
                out["gerr"][names[i]] = _rel_l2(whole, g1[i])
                out["noise"][names[i]] = _rel_l2(gn[i], g1[i])
            del whole
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _tp_seqpar_rank(dev, seed, rank):
    """granite cut to TP_CUT on TP_MESH: the sharded step with
    ``seq_shard_activations`` (counted) and without it, each one's
    collective bytes by kind on this rank, and its gradients (rank 0:
    the two held against each other, leaf by leaf)."""
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import (jit_train_step, make_step_ctx,
                                              shard_batch)
    mesh = make_mesh(TP_MESH, ("data", "model"), dev)
    base = dataclasses.replace(get_config(LM_ARCH), **TP_CUT)
    tg = torch.Generator(dev).manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, base.vocab, (TP_B, TP_S),
                                     generator=tg, device=dev)}
    out, grads = {}, {}
    for sp in (False, True):
        model = get_model(dataclasses.replace(base,
                                              seq_shard_activations=sp))

        def fresh():
            return init_params(model.blueprint(),
                               torch.Generator(dev).manual_seed(seed))
        scfg = StepConfig(remat=True, opt=AdamWConfig())
        step, (_, _, bsh) = jit_train_step(model, mesh, scfg, "train_4k")
        ctx = make_step_ctx(model, mesh, "train_4k")
        lp = ctx.shard_tree(fresh())
        lo = init_opt_state(lp, scfg.opt)
        lb = shard_batch(batch, ctx, bsh)
        torch.cuda.reset_peak_memory_stats()
        col.reset()
        (lp, lo, met), secs, counts, routes = _rank_counts(
            lambda: step(lp, lo, lb))
        coll = col.counters()
        _, secs2 = _sync_s(lambda: step(lp, lo, lb))
        _, sg = value_and_grad(model.sharded(ctx), ctx.shard_tree(fresh()),
                               lb, remat=True,
                               scale=1.0 / ctx.size(ctx.axes))
        grads[sp] = leaves(ctx.unshard_tree(ctx.sum_replicas(sg)))
        out[sp] = {"counts": counts, "routes": routes, "sp": list(ctx.sp),
                   "first_ms": secs * 1e3, "step_ms": secs2 * 1e3,
                   "collectives": coll, "loss": float(met["loss"]),
                   "grad_norm": float(met["grad_norm"]),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del lp, lo, sg
    res = {"counts": out[True]["counts"], "routes": out[True]["routes"],
           "off": out[False], "on": out[True]}
    if rank == 0:
        names = _leaf_names(model.blueprint())
        res["gerr"] = {n: _rel_l2(a, b) for n, a, b in
                       zip(names, grads[True], grads[False])
                       if b.float().any()}
    return res


@contextlib.contextmanager
def _float32_lm():
    """The LM in float32 while inside (the CPU tests' ``float32_lm``): the
    embedding's rows upcast, so that every layer computes in float32
    from float32 params and caches. A check's patch, not a path of the
    port: it holds the sharded logic where bf16 noise on the random
    full-width models (ROADMAP C15) would hide it."""
    from repro_torch.models.transformer import LM
    orig = LM._embed
    LM._embed = lambda self, p, t: orig(self, p, t).float()
    try:
        yield
    finally:
        LM._embed = orig


def _f32_tree(tree):
    return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                    tree)


def _tp_recurrent_rank(dev, seed, rank, arch):
    """jamba (HYBRID_TP_CUT) or xlstm (XLSTM_TP_CUT) on RECURRENT_MESH:
    DEC_STEPS sharded decode steps on DEC_SLOTS slots, and for xlstm a
    sharded prefill of 1 x XLSTM_TP_PREFILL tokens (rank 0: the one-
    process decode_step and prefill against them, and from
    ``_noisy_embed``'s params, C15's yardstick). xlstm's decode and
    prefill again in float32 (``_float32_lm``), uncounted, against one
    process's in float32."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.blueprint import PSpec
    from repro_torch.train.train_step import (jit_decode_step,
                                              jit_prefill_step, make_step_ctx,
                                              shard_batch)
    cut = HYBRID_TP_CUT if arch == HYBRID_ARCH else XLSTM_TP_CUT
    cfg = dataclasses.replace(get_config(arch), **cut)
    model = get_model(cfg)
    mesh = make_mesh(RECURRENT_MESH, ("data", "model"), dev)
    params = init_params(model.blueprint(),
                         torch.Generator(dev).manual_seed(seed))
    step, (_, bsh) = jit_decode_step(model, mesh, "decode_32k")
    ctx = make_step_ctx(model, mesh, "decode_32k")
    lp = ctx.shard_tree(params)
    if rank:
        del params

    def cache(f32=False):
        c = model.init_cache(DEC_SLOTS, DEC_LEN, device=dev)
        return _f32_tree(c) if f32 else c

    def local_cache(f32=False):
        return tree_map(lambda t, sp: ctx.shard(t, sp).clone(), cache(f32),
                        bsh["cache"])
    lcache = local_cache()
    g = torch.Generator(dev).manual_seed(seed + 4)
    toks = torch.randint(0, cfg.vocab, (DEC_SLOTS, DEC_STEPS), generator=g,
                         device=dev)
    vspec = PSpec(ctx.batch or None, None,
                  "model" if ctx.logical("vocab") else None)
    torch.cuda.reset_peak_memory_stats()

    def steps(lp, lcache):
        outs = []
        for t in range(DEC_STEPS):
            pos = torch.full((DEC_SLOTS,), t, device=dev)
            lb = {"tokens": ctx.shard(toks[:, t:t + 1], bsh["tokens"]),
                  "pos": ctx.shard(pos, bsh["pos"]), "cache": lcache}
            outs.append(ctx.unshard(step(lp, lb)[0], vspec))
        return outs

    got, secs, counts, routes = _rank_counts(lambda: steps(lp, lcache))
    out = {"counts": counts, "routes": routes, "ms": secs * 1e3 / DEC_STEPS,
           "cache": [list(map(str, s)) for s in leaves(bsh["cache"])[:2]],
           "local_state": [tuple(t.shape) for t in leaves(lcache)[:2]]}
    pre_toks = None
    if arch == XLSTM_ARCH:
        pre, (_, psh) = jit_prefill_step(model, mesh, "prefill_32k")
        pctx = make_step_ctx(model, mesh, "prefill_32k")
        pg = torch.Generator(dev).manual_seed(seed + 5)
        pre_toks = torch.randint(0, cfg.vocab, (1, XLSTM_TP_PREFILL),
                                 generator=pg, device=dev)
        pspec = PSpec(None, "model" if pctx.logical("vocab") else None)

        def prefill(lp):
            return pctx.unshard(
                pre(lp, shard_batch({"tokens": pre_toks}, pctx, psh)), pspec)
        plog, psecs, pcounts, proutes = _rank_counts(lambda: prefill(lp))
        out["prefill"] = {"counts": pcounts, "routes": proutes,
                          "ms": psecs * 1e3}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if arch == XLSTM_ARCH:      # in float32, after the counted runs
        with _float32_lm():
            lp32 = _f32_tree(lp)
            got32 = steps(lp32, local_cache(True))
            plog32 = prefill(lp32)
        del lp32

    def one(p, f32=False):
        rc = cache(f32)
        dec = [model.decode_step(p, rc, toks[:, t:t + 1],
                                 torch.full((DEC_SLOTS,), t,
                                            device=dev))[0]
               for t in range(DEC_STEPS)]
        pf = None if pre_toks is None else model.prefill(p, pre_toks)
        return dec, pf

    def gap(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a, b))
    if rank == 0:
        dec, pf = one(params)
        ndec, npf = one(_noisy_embed(params))
        out["max_abs_err"], out["noise"] = gap(got, dec), gap(ndec, dec)
        if pf is not None:
            out["prefill"]["max_abs_err"] = gap([plog], [pf])
            out["prefill"]["noise"] = gap([npf], [pf])
        if arch == XLSTM_ARCH:
            with _float32_lm():
                dec32, pf32 = one(_f32_tree(params), f32=True)
            out["f32"] = {"decode": gap(got32, dec32),
                          "prefill": gap([plog32], [pf32]),
                          "scale": max(float(t[t > -1e29].abs().max())
                                       for t in dec32)}
    return out


def _dist_rank(rank, world, port, parts, seed, q):
    """A rank of the distributed phase: joins a gloo world of ``world``
    on this card and runs ``parts`` in turn, putting each one's result
    (or its error) on ``q``."""
    import datetime
    import traceback
    import torch.distributed as dist
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=240))
        for name, args in parts:
            fn = {"gpipe": _gpipe_rank, "tp_train": _tp_train_rank,
                  "tp_decode": _tp_decode_rank,
                  "tp_train_hybrid": _tp_train_hybrid_rank,
                  "tp_seqpar": _tp_seqpar_rank,
                  "tp_recurrent": _tp_recurrent_rank}[name]
            q.put((rank, name, args, fn(dev, seed, rank, *args)))
            torch.cuda.empty_cache()
        dist.destroy_process_group()
    except BaseException:
        q.put((rank, "error", None, traceback.format_exc()))


def _dist_world(world, parts, seed) -> dict:
    """Spawn ``world`` ranks on the card, each running ``parts``; ->
    {part: [each rank's result]}. A rank's error fails the phase."""
    import multiprocessing as mpl
    ctx = mpl.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_dist_rank,
                         args=(r, world, port, parts, seed, q))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    try:
        for _ in range(world * len(parts)):
            rank, name, args, res = q.get(timeout=DIST_TIMEOUT_S)
            if name == "error":
                raise AssertionError(f"distributed rank {rank}:\n{res}")
            out.setdefault((name, tuple(args)), [None] * world)[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return out


def _dist_path(label, results, want) -> tuple:
    """The ranks' launches summed: every kernel of ``want`` launched
    exactly that often in all, none other, each flash_attention and
    flash_attention_bwd launch on the tensor cores; -> (counts, counts
    by route)."""
    counts = {k: sum(r["counts"][k] for r in results) for k in KERNELS}
    routes = {k: {w: sum(r["routes"][k][w] for r in results)
                  for w in ("tensor_cores", "cuda_cores")} for k in ROUTED}
    full = {k: want.get(k, 0) for k in KERNELS}
    if counts != full:
        raise AssertionError(f"{label} launched {counts}; expected {full}")
    for name in ("flash_attention", "flash_attention_bwd"):
        if routes[name] != {"tensor_cores": counts[name], "cuda_cores": 0}:
            raise AssertionError(f"{label}: {name} launched {routes[name]} "
                                 "by route; every launch must take the "
                                 "tensor cores")
    print(f"{label}: launches over the ranks {counts}, by route {routes}")
    return counts, routes


def distributed_phase(seed: int) -> tuple:
    """Several ranks as processes on the one card, talking over gloo (NCCL
    takes one rank a device); every rank computes on the card through the
    port's kernels, and a collective's tensors stay there but for gloo's
    point to point, which goes through host memory (counted). Its times
    are this card's, shared by the ranks: no multi-card claim.

      * GPipe: granite-3-2b's 40 layers in 4 stages of 10 on 4 ranks, 4
        microbatches of 1 x 2048 embedded tokens, against one process
        running the same layers on the same microbatches, bit for bit;
      * the sharded train step on (data 2, model 2), full width cut to 2
        layers, 4 x 2048 tokens: granite-3-2b (32 heads, 8 kv heads, vocab
        sharded 2 ways) and olmoe-1b-7b (32 of 64 experts a rank, bf16
        moments), the loss, every leaf's gathered gradient and the grad
        norm against the one-process step (routers zeroed), and the
        params after AdamW as well;
      * the sharded decode of granite cut to 2 layers, 8 slots, 6 steps,
        on (1, 4) (head-sharded cache) and (1, 3) (nothing divides 3:
        heads replicated, the cache sequence-sharded), against the
        one-process decode_step;
      * granite's sharded train step with ``seq_shard_activations``
        against the same step without it on (2, 2): the loss, every
        leaf's gradient, and the collective bytes by kind a rank;
      * jamba's sharded train step on (2, 2) at full width cut to a mamba
        and an attention layer with dense FFs (HYBRID_TP_CUT, 2.85 B
        params): the loss, the grad norm and every leaf's gradient
        against one process's, the selective scan and its backward on
        each rank's 4,096 of the 16,384 ``d_inner`` channels; its decode
        on (1, 4), 8 slots, 6 steps, against one process;
      * xlstm's decode (8 slots, 6 steps) and a prefill of 1 x 512 on
        (1, 4), one period at full width (one head a rank), against one
        process: in bf16 printed beside C15's yardstick, for information,
        and held in float32 (both sides) at XLSTM_F32_ATOL.

    Where a jamba leaf's gradient misses its tolerance, the one-process
    step's own movement under one bf16 ulp on a tenth of the embedding
    (ROADMAP C15's yardstick) is the bound, printed beside it.

    Returns (the counts by path, a summary)."""
    world4 = _dist_world(4, [("gpipe", ()), ("tp_train", (LM_ARCH,)),
                             ("tp_train", (MOE_ARCH,)),
                             ("tp_decode", (DEC_MESHES[0],)),
                             ("tp_seqpar", ()), ("tp_train_hybrid", ()),
                             ("tp_recurrent", (HYBRID_ARCH,)),
                             ("tp_recurrent", (XLSTM_ARCH,))], seed)
    world3 = _dist_world(3, [("tp_decode", (DEC_MESHES[1],))], seed)
    res = {**world4, **world3}
    by_path, summary = {}, {}
    cfg = get_config(LM_ARCH)
    L = cfg.n_layers

    # GPipe
    gp = res[("gpipe", ())]
    label = f"{LM_ARCH}/gpipe"
    by_path[label], ROUTE_COUNTS[label] = _dist_path(
        label, gp, {"rmsnorm": 2 * L * GPIPE_M,
                    "flash_attention": L * GPIPE_M})
    r0 = gp[0]
    print(f"check {label}: {GPIPE_STAGES} stages x {L // GPIPE_STAGES} "
          f"layers, {GPIPE_M} microbatches of 1 x {GPIPE_S}, against one "
          f"process: max abs err {r0['max_abs_err']:.3g} (bit for bit "
          f"required: the same kernels at the same shapes; largest |y| "
          f"{r0['scale']:.3g})")
    if not r0["ok"] or not all(r["finite"] for r in gp):
        raise AssertionError(f"{label}: pipeline outputs differ from one "
                             "process's")
    print(f"{label}: wall ms per rank (counted run) "
          f"{[round(r['ms'], 1) for r in gp]}, again "
          f"{[round(r['ms_again'], 1) for r in gp]}; bubble share "
          f"{r0['bubble']:.3f}; bytes staged through host by rank "
          f"{[r['staged'] for r in gp]}")
    summary["gpipe"] = {"ms": [r["ms_again"] for r in gp],
                        "bubble": r0["bubble"],
                        "max_abs_err": r0["max_abs_err"],
                        "staged": [r["staged"] for r in gp]}

    # the sharded train steps
    for arch in (LM_ARCH, MOE_ARCH):
        rs = res[("tp_train", (arch,))]
        c = dataclasses.replace(get_config(arch), **TP_CUT)
        Lc = c.n_layers
        fwd = {"rmsnorm": 2 * Lc + 1 + 2 * Lc, "flash_attention": 2 * Lc,
               "rmsnorm_bwd": 2 * Lc + 1, "flash_attention_bwd": Lc}
        if c.moe_experts:
            fwd.update(moe_dispatch=2 * Lc, moe_dispatch_bwd=Lc,
                       moe_combine=3 * Lc)
        world = TP_MESH[0] * TP_MESH[1]
        label = f"{arch}/tp_train"
        by_path[label], ROUTE_COUNTS[label] = _dist_path(
            label, rs, {k: v * world for k, v in fwd.items()})
        r0 = rs[0]
        gap = abs(r0["loss"] - r0["loss_one"])
        gworst = max(r0["gerr"], key=r0["gerr"].get)
        ngap = (abs(r0["grad_norm"] - r0["grad_norm_one"])
                / r0["grad_norm_one"])
        worst = max(r0["perr"].values())
        print(f"check {label} mesh {TP_MESH} (data, model), {Lc} layers at "
              f"full width, {TP_B} x {TP_S} tokens: loss {r0['loss']:.6f} "
              f"vs one process {r0['loss_one']:.6f}, gap {gap:.3g} (atol "
              f"{TRAIN_LOSS_ATOL}); gradients of {len(r0['gerr'])} leaves, "
              f"largest relative L2 error {r0['gerr'][gworst]:.3g} "
              f"({gworst}; tol {TRAIN_GRAD_TOL}); leaves with zero gradient "
              f"{r0['zero_grads']} (sharded {r0['zero_grads_sharded']}); "
              f"grad norm {r0['grad_norm']:.6g} vs {r0['grad_norm_one']:.6g}"
              f", relative gap {ngap:.3g} (tol {TRAIN_GRAD_TOL}); also the "
              f"params after AdamW, largest relative L2 error {worst:.3g} "
              f"(tol {TRAIN_GRAD_TOL})")
        print(f"{label} gradient relative L2 error by leaf {r0['gerr']}")
        if gap > TRAIN_LOSS_ATOL or r0["gerr"][gworst] > TRAIN_GRAD_TOL or \
                r0["zero_grads"] != r0["zero_grads_sharded"] or \
                ngap > TRAIN_GRAD_TOL or worst > TRAIN_GRAD_TOL or \
                len({round(r["loss"], 6) for r in rs}) != 1:
            raise AssertionError(f"{label}: sharded step past tolerance")
        for i, r in enumerate(rs):
            print(f"{label} rank {i}: step {r['step_ms']:.1f} ms (first "
                  f"{r['first_ms']:.1f}), peak {r['peak_gb']:.2f} GB, "
                  f"staged {r['staged']}, collectives {r['collectives']}")
        summary[label] = {"step_ms": [r["step_ms"] for r in rs],
                          "peak_gb": [r["peak_gb"] for r in rs],
                          "loss": r0["loss"], "loss_one": r0["loss_one"],
                          "max_gerr": r0["gerr"][gworst],
                          "grad_norm": r0["grad_norm"],
                          "grad_norm_one": r0["grad_norm_one"],
                          "max_perr": worst}

    # the sharded decode
    label = f"{LM_ARCH}/tp_decode"
    by_path[label] = dict.fromkeys(KERNELS, 0)
    ROUTE_COUNTS[label] = {k: {"tensor_cores": 0, "cuda_cores": 0}
                           for k in ROUTED}
    for shape in DEC_MESHES:
        rs = res[("tp_decode", (shape,))]
        n = shape[0] * shape[1]
        r0 = rs[0]
        print(f"check {LM_ARCH}/tp_decode mesh {shape}: cache "
              f"{r0['cache_spec']} (sequence axes {r0['seq']}), "
              f"{DEC_STEPS} steps at {DEC_SLOTS} slots against one process: "
              f"max abs err {r0['max_abs_err']:.3g} (atol {DECODE_ATOL}); "
              f"ms a step by rank {[round(r['ms'], 2) for r in rs]}")
        if r0["max_abs_err"] > DECODE_ATOL:
            raise AssertionError(f"tp_decode {shape}: past tolerance")
        per, routes = _dist_path(f"{label} {shape}", rs, {
            "rmsnorm": (2 * TP_CUT["n_layers"] + 1) * DEC_STEPS * n})
        for k in KERNELS:
            by_path[label][k] += per[k]
        for k in ROUTED:
            for w, c in routes[k].items():
                ROUTE_COUNTS[label][k][w] += c
        summary[f"{label} {shape}"] = {"ms": [r["ms"] for r in rs],
                                       "max_abs_err": r0["max_abs_err"]}
    _seqpar_checks(res, by_path, summary)
    _hybrid_train_checks(res, by_path, summary)
    _recurrent_checks(res, by_path, summary)
    return by_path, summary


def _world_launches(cfg, world: int) -> dict:
    """A sharded train step's launches over ``world`` ranks, each running
    the whole step's kernels on its shard (``_train_launches``)."""
    return {k: v * world for k, v in _train_launches(cfg).items()}


def _seqpar_checks(res, by_path, summary) -> None:
    rs = res[("tp_seqpar", ())]
    cfg = dataclasses.replace(get_config(LM_ARCH), **TP_CUT)
    world = TP_MESH[0] * TP_MESH[1]
    label = f"{LM_ARCH}/tp_seqpar"
    by_path[label], ROUTE_COUNTS[label] = _dist_path(
        label, rs, _world_launches(cfg, world))
    r0 = rs[0]
    gap = abs(r0["on"]["loss"] - r0["off"]["loss"])
    worst = max(r0["gerr"], key=r0["gerr"].get)
    print(f"check {label} mesh {TP_MESH}, residual split on "
          f"{r0['on']['sp']}: loss {r0['on']['loss']:.6f} vs "
          f"{r0['off']['loss']:.6f} without, gap {gap:.3g} (atol "
          f"{TRAIN_LOSS_ATOL}); gradients of {len(r0['gerr'])} leaves, "
          f"largest relative L2 error {r0['gerr'][worst]:.3g} ({worst}; "
          f"tol {TRAIN_GRAD_TOL})")
    for i, r in enumerate(rs):
        off, on = r["off"], r["on"]
        print(f"{label} rank {i}: step {on['step_ms']:.1f} ms (without "
              f"{off['step_ms']:.1f}), peak {on['peak_gb']:.2f} GB "
              f"(without {off['peak_gb']:.2f}); collective bytes with "
              f"{on['collectives']['bytes']}, without "
              f"{off['collectives']['bytes']}")
        b_on, b_off = on["collectives"]["bytes"], off["collectives"]["bytes"]
        if not (b_on["all-reduce"] < b_off["all-reduce"]
                and b_on["reduce-scatter"] > b_off["reduce-scatter"]
                and b_on["all-gather"] > b_off["all-gather"]):
            raise AssertionError(f"{label} rank {i}: the residual's "
                                 "all-reduces did not become reduce-"
                                 "scatters and all-gathers")
    if gap > TRAIN_LOSS_ATOL or r0["gerr"][worst] > TRAIN_GRAD_TOL:
        raise AssertionError(f"{label}: past tolerance")
    summary[label] = {
        "step_ms": [r["on"]["step_ms"] for r in rs],
        "step_ms_without": [r["off"]["step_ms"] for r in rs],
        "peak_gb": [r["on"]["peak_gb"] for r in rs],
        "loss_gap": gap, "max_gerr": r0["gerr"][worst],
        "bytes": [r["on"]["collectives"]["bytes"] for r in rs],
        "bytes_without": [r["off"]["collectives"]["bytes"] for r in rs]}


def _hybrid_train_checks(res, by_path, summary) -> None:
    rs = res[("tp_train_hybrid", ())]
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), **HYBRID_TP_CUT)
    world = TP_MESH[0] * TP_MESH[1]
    label = f"{HYBRID_ARCH}/tp_train"
    by_path[label], ROUTE_COUNTS[label] = _dist_path(
        label, rs, _world_launches(cfg, world))
    r0 = rs[0]
    gap = abs(r0["loss"] - r0["loss_one"])
    ngap = abs(r0["grad_norm"] - r0["grad_norm_one"]) / r0["grad_norm_one"]
    missed = {k: (e, r0["noise"][k]) for k, e in r0["gerr"].items()
              if e > TRAIN_GRAD_TOL}
    worst = max(r0["gerr"], key=r0["gerr"].get)
    n_params = count_params(get_model(cfg).blueprint())
    print(f"check {label} mesh {TP_MESH}, {n_params / 1e9:.2f} B "
          f"params ({cfg.n_layers} layers at full width: "
          f"{[k.mixer for k in cfg.layer_pattern()]}), {TP_B} x {TP_S} "
          f"tokens: loss {r0['loss']:.6f} vs one process "
          f"{r0['loss_one']:.6f}, gap {gap:.3g} (atol {TRAIN_LOSS_ATOL}); "
          f"grad norm {r0['grad_norm']:.6g} vs {r0['grad_norm_one']:.6g}, "
          f"relative gap {ngap:.3g} (tol 1e-3; C15 yardstick "
          f"{r0['grad_norm_noise']:.3g}); gradients of "
          f"{len(r0['gerr'])} leaves, largest relative L2 error "
          f"{r0['gerr'][worst]:.3g} ({worst}; tol {TRAIN_GRAD_TOL}); "
          f"leaves past it, with the one-process gradient's own movement "
          f"under C15's noise: {missed}")
    print(f"{label} gradient relative L2 error by leaf {r0['gerr']}; "
          f"C15 yardstick by leaf {r0['noise']}")
    for i, r in enumerate(rs):
        print(f"{label} rank {i}: step {r['step_ms']:.1f} ms, peak "
              f"{r['peak_gb']:.2f} GB, collectives {r['collectives']}")
    if gap > TRAIN_LOSS_ATOL or ngap > 1e-3 or any(
            e > n for e, n in missed.values()) or \
            len({round(r["loss"], 6) for r in rs}) != 1:
        raise AssertionError(f"{label}: sharded step past tolerance")
    summary[label] = {"step_ms": [r["step_ms"] for r in rs],
                      "peak_gb": [r["peak_gb"] for r in rs],
                      "loss": r0["loss"], "loss_one": r0["loss_one"],
                      "grad_norm_gap": ngap,
                      "max_gerr": r0["gerr"][worst], "missed": missed}


def _recurrent_checks(res, by_path, summary) -> None:
    n = RECURRENT_MESH[0] * RECURRENT_MESH[1]
    for arch, cut in ((HYBRID_ARCH, HYBRID_TP_CUT),
                      (XLSTM_ARCH, XLSTM_TP_CUT)):
        rs = res[("tp_recurrent", (arch,))]
        cfg = dataclasses.replace(get_config(arch), **cut)
        r0 = rs[0]
        norms = 2 * cfg.n_layers + 1 if arch == HYBRID_ARCH \
            else cfg.n_layers + 1
        label = f"{arch}/tp_decode"
        by_path[label], ROUTE_COUNTS[label] = _dist_path(
            label, rs, {"rmsnorm": norms * DEC_STEPS * n})
        print(f"check {label} mesh {RECURRENT_MESH}, {cfg.n_layers} layers "
              f"at full width, cache {r0['cache']} (local "
              f"{r0['local_state']}), {DEC_STEPS} steps at {DEC_SLOTS} "
              f"slots against one process: max abs err "
              f"{r0['max_abs_err']:.3g} (C15 yardstick {r0['noise']:.3g}"
              + (f"; atol {DECODE_ATOL})" if arch == HYBRID_ARCH else
                 f"; information only: the float32 check below holds it)")
              + f"; ms a step by rank {[round(r['ms'], 2) for r in rs]}, "
              f"peak GB {[round(r['peak_gb'], 2) for r in rs]}")
        if arch == HYBRID_ARCH and r0["max_abs_err"] > DECODE_ATOL:
            raise AssertionError(f"{label}: past tolerance")
        summary[label] = {"ms": [r["ms"] for r in rs],
                          "peak_gb": [r["peak_gb"] for r in rs],
                          "max_abs_err": r0["max_abs_err"],
                          "noise": r0["noise"]}
        if arch != XLSTM_ARCH:
            continue
        f32 = r0["f32"]
        print(f"check {arch} float32 (decode and prefill sharded on "
              f"{RECURRENT_MESH} against one process, both in float32): "
              f"decode max abs err {f32['decode']:.3g}, prefill "
              f"{f32['prefill']:.3g} (atol {XLSTM_F32_ATOL}; largest "
              f"|logit| {f32['scale']:.3g}, the padded vocab's -1e30 "
              f"aside)")
        if max(f32["decode"], f32["prefill"]) > XLSTM_F32_ATOL:
            raise AssertionError(f"{arch}: float32 sharded decode or "
                                 "prefill past tolerance")
        summary[label]["f32"] = f32
        label = f"{arch}/tp_prefill"
        pre = [r["prefill"] for r in rs]
        by_path[label], ROUTE_COUNTS[label] = _dist_path(
            label, pre, {"rmsnorm": norms * n})
        p0 = pre[0]
        print(f"check {label} mesh {RECURRENT_MESH}, 1 x {XLSTM_TP_PREFILL} "
              f"tokens against one process: max abs err "
              f"{p0['max_abs_err']:.3g} (C15 yardstick {p0['noise']:.3g}; "
              f"information only: the float32 check above holds it); ms by "
              f"rank {[round(p['ms'], 1) for p in pre]}")
        summary[label] = {"ms": [p["ms"] for p in pre],
                          "max_abs_err": p0["max_abs_err"],
                          "noise": p0["noise"]}


#: the port's examples on the card, each at a small size (the script's
#: arguments)
EXAMPLES = [("torch_quickstart.py", []), ("torch_volt_simt_demo.py", []),
            ("torch_serve_lm.py", []), ("torch_serve_lm.py", ["--storm"]),
            ("torch_serve_lm.py", ["--launch-storm"]),
            ("torch_train_lm.py", ["--steps", "20", "--batch", "4",
                                   "--seq", "128"])]


def examples_phase() -> None:
    """Each of the port's examples on the card (no ``--device``), in a
    process of its own, all at once: each must exit 0; its last line is
    printed."""
    root = Path(__file__).resolve().parent
    scratch = root / "build" / "examples"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               VOLT_CACHE_DIR=str(scratch / "volt_cache"))
    procs = []
    for i, (script, args) in enumerate(EXAMPLES):
        extra = (["--ckpt", str(scratch / "ckpt")]
                 if script == "torch_train_lm.py" else [])
        procs.append(((script, args), subprocess.Popen(
            [sys.executable, str(root / "examples" / script), *args,
             *extra], cwd=scratch, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    bad = []
    for (script, args), p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        last = (out.strip().splitlines() or ["(no output)"])[-1]
        print(f"example {script} {' '.join(args)}: rc {p.returncode}; "
              f"{last}")
        if p.returncode != 0:
            bad.append((script, args, err[-2000:]))
    shutil.rmtree(scratch, ignore_errors=True)
    if bad:
        raise AssertionError(f"examples failed on the card: {bad}")




def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. the card
    print(_smi("name,power.limit").splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # inputs and compiled VIR for every case
    rng = np.random.default_rng(args.seed)
    cases = {}
    for name, local in CASES:
        bench = suite.BENCHES[name.rstrip("01")]
        bufs, sc, params = _inputs(name, rng, local)
        mod = bench.handle.build(None)
        ck = run_pipeline(mod, bench.handle.name, CONFIG)
        cases[name] = (bench, bufs, sc, params, ck)

    # 2. build every kernel, one nvcc each, all at once
    t0 = time.perf_counter()
    srcs, alias_srcs = {}, {}
    for name, (bench, bufs, sc, params, ck) in cases.items():
        cpu = {k: torch.from_numpy(v) for k, v in bufs.items()}
        srcs[name] = sx.kernel_source(ck.fn, params, cpu)
        if name in ALIASED:
            a, b = ALIASED[name]
            alias_srcs[name] = sx.kernel_source(ck.fn, params,
                                                {**cpu, a: cpu[b]})
    with ThreadPoolExecutor(9) as pool:
        lm_built = {m.KERNEL.kind: pool.submit(m.KERNEL.build)
                    for m in (rn, fa, md, ss, rb, fb, mc, mb, sb)}
        built = sx.build_many(list(srcs.values())
                              + list(alias_srcs.values()))
        for kind, fut in lm_built.items():
            so, secs = fut.result()
            print(f"build {kind:15s} {so.name[:12]} nvcc {secs:.1f} s")
    for name, (so, secs) in zip(srcs, built):
        print(f"build {name:13s} {so.name[:12]} nvcc {secs:.1f} s")
    print(f"build total {time.perf_counter() - t0:.1f} s")
    for m in (*ROUTED.values(), rb, sb):
        for line in _ptxas_lines(m.KERNEL):
            print(f"ptxas {line}")

    # 3. the main path at full size, counted
    _zero_counts()
    outs, launches, ctas = {}, {}, {}
    for name, (bench, bufs, sc, params, ck) in cases.items():
        before = sx.LAUNCHES
        outs[name] = volt_torch_run(bench.handle, bufs, params, sc,
                                    CONFIG, device=dev)
        launches[name] = sx.LAUNCHES - before
        ctas[name] = sx.last_ctas(srcs[name])
        if ctas[name] < 1:
            raise AssertionError(f"{name}: the main path did not launch the "
                                 f"library built from its source")
    torch.cuda.synchronize()
    total = sx.LAUNCHES
    if (total != len(cases) or min(launches.values()) < 1
            or sum(_counts().values()) != total):
        raise AssertionError(f"main path launched {launches}")
    print(f"main path: {total} CUDA launches {launches}")

    # held against the plain version on the card and numpy
    errs = {}
    for name, (bench, bufs, sc, params, ck) in cases.items():
        plain = sx.simt_launch_plain(ck.fn, params, to_tensors(bufs, dev), sc)
        tol = 1e-5 if name.rstrip("01") in EXP_LOG else 0.0
        errs[name] = _compare(name, outs[name], plain, tol, tol)
        ref, atol = _numpy_ref(name, bufs, sc)
        msg = ""
        if ref is not None:
            ref_t = {k: torch.from_numpy(v).to(dev) for k, v in ref.items()}
            e = _compare(name + "/numpy", outs[name], ref_t, 0.0, atol)
            msg = f", numpy max abs err {e:.3g} (atol {atol})"
        print(f"check {name:13s} vs plain max abs err {errs[name]:.3g} "
              f"(tol {tol}){msg}")

    # 4. the whole-buffer backend on the card: sgemm at the suite's size
    b = suite.BENCHES["sgemm"]
    bufs, sc, params = b.make(np.random.default_rng(args.seed))
    mod = b.handle.build(None)
    ck = run_pipeline(mod, "sgemm", CONFIG)
    tk = compile_torch(ck.fn, params, mod, device=dev)
    got = tk.fn(to_tensors(bufs, dev), sc)
    want = b.ref(bufs, sc)
    e = _compare("sgemm/compile_torch", got,
                 {k: torch.from_numpy(v).to(dev) for k, v in want.items()},
                 0.0, b.atol)
    print(f"check compile_torch sgemm vs numpy max abs err {e:.3g} "
          f"(atol {b.atol})")

    # 5. times: CUDA events, median of --reps runs, the plain one beside
    records = []
    for name, (bench, bufs, sc, params, ck) in cases.items():
        tens = to_tensors(bufs, dev)
        ms = _median_ms(lambda: sx.simt_launch(ck.fn, params, tens, sc),
                        args.reps)
        plain_ms = _median_ms(
            lambda: sx.simt_launch_plain(ck.fn, params, tens, sc), args.reps,
            batch=1)
        L = params.grid * params.wg_threads
        nbytes = _traffic(ck.fn) * L * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        lanes_ops = _lane_ops(ck.fn, L)
        ops_ms = lanes_ops / F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        # the yardstick: one torch call computing the same function
        n = sc["n"]
        if name == "vecadd":
            x, y, z = tens["x"][:n], tens["y"][:n], tens["z"][:n]
            lib_fn = lambda: torch.add(x, y, out=z)  # noqa: E731
        elif name == "saxpy":
            x, y = tens["x"][:n], tens["y"][:n]
            lib_fn = lambda: y.add_(x, alpha=sc["a"])  # noqa: E731
        elif name == "psum":   # a scan never reads past its lane
            x, y = tens["x"].view(-1, 32), tens["y"].view(-1, 32)
            lib_fn = lambda: torch.cumsum(x, 1, out=y)  # noqa: E731
        else:
            lib_fn = None
        library_ms = None if lib_fn is None else _median_ms(lib_fn, args.reps)
        lib = "" if library_ms is None else f" library {library_ms:.4f} ms"
        print(f"time {name:13s} {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"{nbytes} B {bytes_ms:.4f} ms  {lanes_ops} lane ops "
              f"{ops_ms:.4f} ms  bound {bound_ms:.4f} ms by {bound_by}  "
              f"achieved {bound_ms / ms:.3f} of bound{lib}")
        # device time from a profiler trace, beside the event time above
        dev_ms, kernels, per_call = _device_ms(
            lambda: sx.simt_launch(ck.fn, params, tens, sc))
        lib_dev = (None,) if lib_fn is None else _device_ms(lib_fn)
        print(f"device {name:13s} kernel "
              + ("not measured" if dev_ms is None else
                 f"{dev_ms:.4f} ms ({per_call:g} records/call {kernels})")
              + f" events {ms:.4f} ms"
              + ("" if lib_dev[0] is None else
                 f"  library kernel {lib_dev[0]:.4f} ms"))
        # the barrier pair's cost: the same kernel on buffers that share
        # storage, so every store keeps its pair
        aliased_ms = None
        if name in ALIASED:
            a, b = ALIASED[name]
            shared = {**tens, a: tens[b]}
            aliased_ms = _median_ms(
                lambda: sx.simt_launch(ck.fn, params, shared, sc), args.reps)
            print(f"aliased {name:13s} {a} is {b}, every store between two "
                  f"barriers: {aliased_ms:.4f} ms against {ms:.4f} ms")
        mode = "warp" if codegen.warp_mode(params.wg_threads) else "cta"
        syncs = srcs[name].count("__syncthreads")
        warps = srcs[name].count("__syncwarp")
        print(f"mode {name:13s} {mode}: {ctas[name]} CTAs on the main path, "
              f"{syncs} __syncthreads and {warps} __syncwarp in the source")
        records.append({"name": f"simt_exec/{name}", "route": "cuda",
                        "source": SOURCE, "replaces": REPLACES,
                        "launches": launches[name],
                        "launches_by_path": {"compiler": launches[name]},
                        "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms,
                        "device_ms": dev_ms, "mode": mode,
                        "ctas": ctas[name], "syncthreads": syncs,
                        "syncwarp": warps, "aliased_ms": aliased_ms})

    # 6. the VOLT Runtime on the card, its torch rung counted: telemetry
    # set to 0 just before, read just after
    t0 = time.perf_counter()
    cache_dir = Path(__file__).resolve().parent / "build" / "volt_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)
    os.environ["VOLT_CACHE_DIR"] = str(cache_dir)
    torchgen.reset_torch_telemetry()
    rt_records = runtime_phase(dev, args.seed, cases, outs)
    tel = dict(torchgen.TORCH_TELEMETRY)
    want = len(RT_LICENSED) + len(RT_BIG)
    if (tel["engaged"] < want or tel["certified"] != want
            or tel["refusals"] or tel["demotions"] or tel["routed_small"]):
        raise AssertionError(f"runtime phase telemetry {tel}")
    shutil.rmtree(cache_dir, ignore_errors=True)
    print(f"runtime phase: torch rung telemetry {tel}")
    print(f"runtime phase {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"runtime": rt_records}))

    # 7. both tensor-core routes with a value past fp16's range (C13)
    t0 = time.perf_counter()
    past_fp16 = fp16_range_checks(dev, args.seed)
    print(f"fp16 range phase {time.perf_counter() - t0:.1f} s")

    # 8. the LM serving paths, dense, MoE, hybrid and recurrent; each
    # kernel's record counts its launches on every path
    t0 = time.perf_counter()
    lm_records, paths = lm_phase(dev, args.seed, args.reps)
    print(f"lm phase {LM_ARCH} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_records, moe_paths = moe_phase(dev, args.seed, args.reps)
    print(f"lm phase {MOE_ARCH} {time.perf_counter() - t0:.1f} s")
    paths.update(moe_paths)
    lm_records["flash_attention"]["d128"] = moe_records.pop(
        "flash_attention_d128")
    lm_records.update(moe_records)
    t0 = time.perf_counter()
    hybrid_records, hybrid_paths = hybrid_phase(dev, args.seed, args.reps)
    print(f"lm phase {HYBRID_ARCH} {time.perf_counter() - t0:.1f} s")
    paths.update(hybrid_paths)
    for name in ("rmsnorm", "flash_attention", "moe_dispatch"):
        lm_records[name]["jamba"] = hybrid_records.pop(name)
    lm_records.update(hybrid_records)
    t0 = time.perf_counter()
    kimi_records, kimi_paths = kimi_phase(dev, args.seed, args.reps)
    print(f"lm phase {KIMI_ARCH} {time.perf_counter() - t0:.1f} s")
    paths.update(kimi_paths)
    for name in ("rmsnorm", "flash_attention", "moe_dispatch"):
        lm_records[name]["kimi"] = kimi_records.pop(name)
    t0 = time.perf_counter()
    xlstm_records, xlstm_paths = xlstm_phase(dev, args.seed, args.reps)
    print(f"lm phase {XLSTM_ARCH} {time.perf_counter() - t0:.1f} s")
    paths.update(xlstm_paths)
    lm_records["rmsnorm"]["xlstm"] = xlstm_records["rmsnorm"]
    for name, r in past_fp16.items():
        lm_records[name]["past_fp16"] = r
    t0 = time.perf_counter()
    train_records, train_paths, summary = train_phase(dev, args.seed,
                                                      args.reps)
    print(f"train phase {LM_ARCH} {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"train": summary}))
    paths.update(train_paths)
    lm_records.update(train_records)
    t0 = time.perf_counter()
    moe_train, moe_train_paths, moe_summary = moe_train_phase(
        dev, args.seed, args.reps)
    print(f"train phase {MOE_ARCH} {time.perf_counter() - t0:.1f} s")
    paths.update(moe_train_paths)
    t0 = time.perf_counter()
    hybrid_train, hybrid_train_paths, hybrid_summary = hybrid_train_phase(
        dev, args.seed, args.reps)
    print(f"train phase {HYBRID_ARCH} {time.perf_counter() - t0:.1f} s")
    paths.update(hybrid_train_paths)
    print(json.dumps({"train_moe_hybrid": [moe_summary, hybrid_summary]}))
    lm_records["moe_dispatch_bwd"] = {
        **moe_train["moe_dispatch_bwd"],
        "jamba": hybrid_train["moe_dispatch_bwd"]}
    lm_records["selective_scan_bwd"] = hybrid_train["selective_scan_bwd"]
    t0 = time.perf_counter()
    cross_rows, encdec_paths, encdec_train = encdec_phase(dev, args.seed,
                                                          args.reps)
    print(f"lm phase {ENCDEC_ARCH} {time.perf_counter() - t0:.1f} s")
    paths.update(encdec_paths)
    for name, rows in cross_rows.items():
        lm_records[name]["seamless"] = rows
    t0 = time.perf_counter()
    vlm_paths, vlm_train = vlm_phase(dev, args.seed, args.reps)
    print(f"train phase {VLM_ARCH} {time.perf_counter() - t0:.1f} s")
    paths.update(vlm_paths)
    print(json.dumps({"train_encdec_vlm": [encdec_train, vlm_train]}))
    t0 = time.perf_counter()
    dist_paths, dist_summary = distributed_phase(args.seed)
    print(f"distributed phase {time.perf_counter() - t0:.1f} s")
    paths.update(dist_paths)
    print(json.dumps({"distributed": dist_summary}))
    t0 = time.perf_counter()
    examples_phase()
    print(f"examples phase {time.perf_counter() - t0:.1f} s")
    for name, r in lm_records.items():
        src, replaces = LM_SOURCES[name]
        per_path = {p: n[name] for p, n in paths.items()}
        by_route = {} if name not in ROUTED else {"launches_by_route": {
            p: n[name] for p, n in ROUTE_COUNTS.items()}}
        records.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": sum(per_path.values()),
                        "launches_by_path": per_path, **by_route, **r})

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
