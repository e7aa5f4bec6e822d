#!/usr/bin/env python3
"""Drive the PyTorch/Hopper port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, on one card

Phases, each of which must pass (any failure exits nonzero):

1. build: every CUDA source under ``src/repro_torch/csrc`` is compiled by
   ``nvcc`` for ``sm_90a`` (one process per source, all together) and the
   Triton RMSNorm forward and backward are compiled on their first call;
2. kernels: each hand-written kernel, on the card, at small shapes and at
   the tinyllama-1.1b shapes of the serving and training paths (K2 and K3
   at the training path's q (2,32,4096,64) and 8192 rows too), is held
   against its plain PyTorch version on the same inputs within the stated
   tolerance, and timed beside the plain version and one PyTorch library
   call computing the same function (the port itself never calls those);
   the bf16 flash kernels, which run on tensor cores and round p (K2, K5a,
   K5b) and ds (K5a, K5b) to bf16 as operands, are held by relative norm
   against their plain versions with bf16 operands (``*_KERNEL_REL_NORM``)
   and the fp32 plain versions (``*_FP32_REL_NORM``), with SDPA's relative
   norm printed beside them at the training shape; there their two
   launches must give bit-equal results, all three are timed causal and
   non-causal (the ratios printed), and, where ``cuobjdump`` is found,
   every bf16 forward and backward kernel must show HMMA/HGMMA
   instructions in its SASS; K1 prints its split of the lanes' tables
   and is held with lanes of 1, 4 and 16 live pages and an all -1 lane;
   the autograd Functions of K2+K5 and K3 are held against autograd
   through the plain forwards (K3's at 512 and 8192 rows); K3's forward
   is timed at every shape class of the main paths (a decode step's 8
   rows, a prefill's 1000, a training norm's 8192, at widths 2048-5120,
   and phi-3-vision's training norms, 4096 and 8192 rows of 3072) and its
   backward (``rmsnorm_bwd``) held against ``rmsnorm_bwd_ref`` at 8192 x
   2048, 4096 x 3072, 8192 x 3072, 4096 x 3840, 65536 x 256, 32768 x 256,
   1000 x 2560 and 1000 x 5120 in bf16
   (dx at one bf16 ulp, dgain at one ulp and, from an fp32 gain, by
   ``RMS_DGAIN_REL_NORM``) and 33 x 128 in fp32, two launches bit-equal
   at the training shapes and timed there;
3. serve: full-width tinyllama-1.1b (random weights from seed 0) serves 8
   requests with prompts of 64..1024 tokens (native and chunked prefill)
   and 32 new tokens each through ``launch.serve``, that is
   ``Cluster.submit`` (sizing, placement, the ladder) and the
   ``TorchExecutor``'s engine behind the pod's router; every request must
   complete and every kernel's launch count must equal what the path
   implies (counts are zeroed just before and read just after); then the
   same serve, 8 new tokens each, under ``torch.profiler`` gives the
   device's busy share and the device time by kernel;
4. parity: reduced tinyllama-1.1b serves the same prompts with the same
   weights on the card and on the CPU (the plain versions) in this process;
   the greedy tokens must be equal except where the CPU run's top-2 logit
   gap is below ``TIE_GAP`` (then that request stops being compared);
5. train: full-width tinyllama-1.1b (random weights from seed 0) takes 4
   AdamW steps at sequence 4096, global batch 8 in 4 microbatches under
   full remat, through ``launch.train`` (``Cluster.submit`` with those
   two fields as overrides of the ladder's plan; the ladder's own plan
   and its estimate are printed beside the measured peak, which the
   job's grant must cover); every loss must be finite and the last
   below the first,
   every step-1 gradient finite and not all zero (computed here, before
   the run, from the same weights and batch as the run's first step), and
   every kernel's launch count what the path implies (K3's backward once
   per norm and microbatch); then one more step under ``torch.profiler``,
   which also gives K3's forward kernels and the device time under the
   norm's autograd node;
6. parity: reduced tinyllama-1.1b (full remat), zamba2-2.7b (two
   pattern blocks, so the shared attention block runs twice, under
   ``remat="dots"``), rwkv6-7b, qwen2-moe-a2.7b, dbrx-132b,
   phi-3-vision-4.2b (with seeded image embeddings), whisper-base (with
   seeded frames) and gemma3-12b (one 5:1 period, window 8, qk-norm, tied
   embeddings; all full remat) each train 3 steps from the same
   weights on the same batches on the card and on the CPU; losses, final
   params and step-1 gradients must agree within ``TRAIN_*_RTOL`` (the
   MoE configs' step-1 gradients on the card's routing, the tokens whose
   experts the CPU's own routing swaps counted: :func:`pinned_routes`);
7. dense serve: full-width zamba2-2.7b (random weights from seed 0)
   serves 8 requests with prompts of 64..1024 tokens and 32 new tokens
   each through the dense backend (cache_len 2048), by ``launch.serve``
   and so ``Cluster.submit``; every request must
   complete and the launch counts of K2, K3, K4 and K7 must equal what the
   path implies; then the same traffic with 8 new tokens under
   ``torch.profiler`` gives the busy share and the device time of K7's
   kernels summed;
8. dense serve: full-width rwkv6-7b, the same traffic, K3 and K6;
9. parity: reduced zamba2-2.7b, rwkv6-7b and tinyllama-1.1b serve mixed
   prompts (9..200 tokens) densely with the same weights on the card and
   on the CPU; greedy tokens equal under the ``TIE_GAP`` rule;
10. history: the §9.3 loop on the card -- phase 3's serving application
   is submitted to one ``Cluster`` whose ``HistoryStore`` lives in a
   fresh temporary directory, run and released, then submitted again and
   run on the same requests; the greedy tokens must be equal, the history
   must hold the first run's observations, and the second submission's
   demand (``SizingSolution``) and its pool's grants must come from
   ``policy="history"`` over that non-empty history; each run's launch
   counts are checked as in phase 3; each run's grant (the job's bytes
   in the scheduler, grown by the ``TorchExecutor`` to what the app
   holds) must cover its measured peak, and the history must record the
   first run's grant; the sizing, demand, grants, plan and both runs'
   peak memory are printed;
11. gemma3: full-width gemma3-12b (48 layers, 40 of them sliding-window
   with window 1024, head dim 256; random bf16 weights from seed 0)
   serves 8 requests with prompts of 64..2048 tokens (two past the ring
   of 9 x 128 tokens) and 32 new tokens each through ``launch.serve`` on
   the paged backend with ring pages; every request must complete, the
   launch counts of K1, K2 and K3 must equal what the path implies, and
   the ring pages held must never pass 9 per running request; TTFT,
   decode step and peak memory against the plan's estimate are printed,
   then a profiled serve gives the busy share; the same weights then
   serve 2 requests of 1500-token prompts and 80 new tokens on the paged
   backend and on the dense backend (K4 over the ring cache), whose
   greedy tokens must be equal under the ``TIE_GAP`` rule; last, the
   ladder's plans of full-width mistral-nemo-12b and command-r-35b on
   the card's mesh are printed (host arithmetic);
12. mistral: full-width mistral-nemo-12b (40 layers, d 5120, 32/8 heads
   of 128; random bf16 weights from seed 0, made once) serves 8
   requests, each a shared 1500-token system prompt and its own 64..512
   tokens (seed 0), 32 new tokens, through ``launch.serve``'s
   ``submit_app`` (``Cluster.submit``, the ``TorchExecutor``, a view of
   the pod's shared pool of 192 pages, ``chunk_pages`` 4, max batch 8):
   request 0 alone, then the other 7 together.  (a) cold, no prefix
   cache; (b) warm, the prefix cache on: tokens equal to (a)'s under the
   ``TIE_GAP`` rule, hit rate 7/8, at least one copy-on-write, fewer
   prefill pages computed; TTFT, decode step, peak memory and the plan's
   estimate printed, then (b)'s traffic with 8 new tokens under
   ``torch.profiler`` (busy share); (c) a pod pool of 48 pages: request
   2 decodes through its pinned prefix pages while a full-width
   tinyllama-1.1b co-tenant's 3 requests overshoot the free list, so
   refcount-0 cache pages are evicted, and request 2's tokens equal a
   calm run's; (d) 2 replicas on one store and one set of weights,
   replica 1 drained mid-decode: its requests migrate with their KV and
   prefix, none requeued, tokens equal to (b)'s.  Every run's launch
   counts are what its path implies; every release returns the store's
   bytes, and no run's peak passes (a)'s by more than 1 GiB;
13. park: idle parking and the autoscale control plane.  (a) two
   full-width tinyllama-1.1b serve apps (``submit_app``, max batch 4)
   on one pod pool of 128 pages and one aliased store: a (the prefix
   cache on) serves phase 3's first four prompt lengths, which share
   their first 256 tokens, a0 alone and then a1-a3 (3 prefix hits), b
   the last four; 64 new tokens.  After 8 steps of both, a is parked, b
   steps 8 times, one more request to a unparks it, and twice more a
   parks while b steps twice; at a's 40th decode step a parks, b parks
   (the store goes with the last active user), b and a unpark, and both
   run to the end.  Against a calm run of the same schedule: b's tokens
   and a's up to its 40th decode step exactly equal, a's requeued
   requests (their cache pages were flushed) and a's last request under
   the ``TIE_GAP`` rule; every receipt frees the job's bytes and drains,
   restores and requeues what the schedule implies; each park's
   requested device bytes fall by at least the weights (with the store
   when it goes) less 1 MiB, each unpark brings them back within 1 MiB,
   the releases to where they were.  (b) ``launch.serve``'s
   ``--autoscale`` path at full width with ``--trace``: the idle parker
   parks the app, its weights leave the card, burst 2 unparks it, the
   trace's summary shows one park, one unpark and the decisions, and
   the tokens equal an app's that was never parked.  (c) full-width
   zamba2-2.7b, dense, max batch 3, phase 7's first 4 prompts, 32 new:
   parked and unparked after 8 steps (the bytes of its weights and dense
   cache freed), tokens equal to a calm run's.  (d) reduced gemma3-12b
   on ring pages, 3 x 200 + 70, parked 3 times after 60 steps (its
   rings wrapped), tokens equal to a calm run's.  Each park's and
   unpark's wall time and host-transfer rate are printed.
14. train zamba2: full-width zamba2-2.7b (54 layers: 9 x (5 Mamba-2 +
   the shared attention block at head dim 80); random weights from seed
   0) trains as phase 5 does -- sequence 4096, global batch 8, 4
   microbatches, 4 AdamW steps through ``launch.train`` -- under
   ``remat="dots"`` (each pattern block keeps its matmuls' outputs and
   runs the rest, every kernel's forward with it, again in the
   backward), with phase 5's gates: the ladder's own plan and estimate
   beside the measured peak, which the job's grant must cover; finite,
   falling losses; finite, nonzero step-1 gradients; K2, K5a/K5b at 80,
   K3 and its backward (at 2560 and the Mamba-2 inner 5120) and K7
   launched exactly as often as the path implies (the scan gradients are
   PyTorch ops in ``SSDScan``'s backward); then the step time, tokens/s,
   the model-FLOPs share (``model_flops``: matmuls and causal attention,
   not the scans) and a profiled step: the busy share and the device
   time of K7, the SSD backward, K5 and cuBLAS;
15. train rwkv6: full-width rwkv6-7b (d 4096, 64 heads of 64) with 8 of
   its 32 layers (the full depth does not fit one card) under full
   remat, 4 microbatches, phase 14's gates and report; K6 (its gradient
   in ``WKV``'s backward), K3 and its backward;
16. families: random bf16 weights from seed 0 at full width, each run's
   freed before the next: qwen2-moe-a2.7b at its full 24 layers (8
   requests of 64..1024 tokens, 32 new) and dbrx-132b at 4 of its 40
   layers (the full depth needs more than one card; 4 requests of
   256..1024, 16 new) through ``launch.serve`` on the dense backend, as
   phase 7 serves (every request completes, exact launch counts of K2,
   K3 and K4), with the tokens the experts' capacity dropped at prefill,
   the decode step beside its weight-read floor, the peak beside the
   plan's estimate, and a profiled run (busy share; the routed experts'
   device time against attention's); phi-3-vision-4.2b's text prompts so
   too, then ``Model.prefill`` with 2 lanes of 576 seeded image
   embeddings ahead of a 128-token prompt and 32 decode steps from
   position 704; whisper-base's ``Model.prefill`` on 4 lanes of seeded
   (1500, 512) frame features and a 4-token prompt, then 64 decode steps
   (cache 448; K2 18 times a prefill, K4 12 times a step, no K3: whisper
   norms with LayerNorm); the two ``Model.prefill`` runs also hold their
   first decode step to a prefill over one more token by the rule of
   ``tests/test_arch_smoke.py``;
17. parity: reduced qwen2-moe-a2.7b and dbrx-132b on the dense backend,
   reduced phi-3-vision-4.2b with image embeddings and whisper-base with
   frame features through ``Model.prefill`` and 8 greedy steps, each on
   the card and on the CPU with the same weights and inputs; greedy
   tokens equal under the ``TIE_GAP`` rule;
18. train families: at phase 5's sequence 4096 x batch 8 and optimizer,
   random weights from seed 0, each run's memory freed before the next,
   the allocator's segments expandable:
   (a) qwen2-moe-a2.7b at full width with 4 of its 24 layers (the full
   depth needs more than one card), full remat, 4 microbatches, the CE
   in chunks of 1024 positions, 4 steps through ``launch.train`` with
   phase 5's gates, the (token, k) pairs the capacity drops in each step
   and the step-1 batch's aux beside its ce; (b) phi-3-vision-4.2b at
   full width with ``PHI3_TRAIN_LAYERS`` (28) of its 32 layers (the full
   depth does not fit the card) through ``launch.train`` on its text
   (the runtime's batches), full remat, 8 microbatches of one sequence;
   (c) phi-3-vision-4.2b at
   4 of its 32 layers and (d) whisper-base through ``make_train_step``
   on the ladder's plan with full remat and 4 microbatches, with 576
   seeded image embeddings ahead of 3520 tokens (3 steps) and 1500
   seeded frames (4 steps): finite, falling losses; every step-1
   gradient leaf finite and not all zero, the encoder's, ``cross_w*``'s
   and ``img_proj``'s included (but (b)'s ``img_proj``, which text does
   not reach: exactly zero); exact launch counts (whisper's K2/K5 also by
   call shape: causal self, cross, encoder); the peak beside the plan;
   then the step time, tokens/s, the model-FLOPs share
   (:func:`model_flops`) and a profiled step (busy share, the device time
   of K2, K5, cuBLAS and the routed experts);
19. train gemma3: ``launch.train`` of the full 48 layers at phase 5's
   4096 x 8 must be refused before any weights are made, naming its
   180.85 GiB plan (host arithmetic); then full-width gemma3-12b (d 3840,
   16/8 heads of 256, d_ff 15360, vocab 262144, tied embeddings; random
   weights from seed 0) with ``GEMMA3_TRAIN_LAYERS`` of its 48 layers
   (10 sliding-window layers of window 1024 and 2 global), full remat, 8
   microbatches of one sequence, the CE in chunks of 1024 positions, 4
   AdamW steps through ``launch.train`` with phase 5's gates (the
   ladder's own plan and the run's printed beside the measured peak,
   which the job's grant must cover; finite, falling losses; every
   step-1 gradient leaf finite and nonzero, ``q_norm``, ``k_norm`` and
   the tied ``embed`` among them; exact launch counts of K2, K5a and K5b
   at head dim 256, windowed and global counted apart by call shape, and
   of K3 and its backward, four norms a layer), the allocator's segments
   expandable; then the step time, tokens/s, the model-FLOPs share (a
   windowed layer's attention over its window's pairs) and a profiled
   step (busy share; K2, K5, K3 and cuBLAS);
20. sharded training: one card first runs phase 5's plan (seed-0
   weights, phase 5's batches and optimizer) for ``SHARDED_STEPS`` steps
   and keeps its losses, step-1 gradients and final params on the host;
   then ``SHARDED_WORLD`` = 4 rank processes (``sharded_rank``; a
   ``file://`` rendezvous in a temporary directory under ``build/``;
   NCCL and a card each with four cards, else gloo with every rank on
   ``cuda:0``; the kernels loaded from phase 1's build) each call
   ``launch.train`` on the ``h100x4`` mesh (``Cluster.submit``, the
   ``TorchExecutor`` on the rank's card) with each plan of
   ``SHARDED_PLANS`` -- the ladder's own at batch 8 (data parallel over
   ("data", "model"), ZeRO) and the TP + ZeRO + FSDP plan the ladder
   picks at train_4k's batch of 256 -- full width, full remat,
   microbatches of 2 rows a rank, the same seeded weights and batches.
   Gates: finite, falling losses; rank 0's launch counts of K2, K5a,
   K5b, K3 and the K3 backward what the path implies; the grant (the
   largest rank's footprint, which every rank's control plane takes)
   covering every rank's measured peak; losses, step-1 gradients
   (gathered whole from the ranks' optimizer slices) and final params
   within ``TRAIN_*_RTOL`` of one card's; the TP plan's params saved
   from the ranks' blocks (rank 0 writes) and restored onto a (4, 1)
   mesh and onto one process bit for bit.  Printed: each plan, its
   estimate, each rank's peak, and, from the last step, which rank 0
   runs under ``torch.profiler``, the step time, the NCCL kernels'
   share of the device busy time and the host time inside gloo's
   collectives.

A failed comparison of a kernel with its plain version prints, before
the run stops, its first 8 bad elements with both values, the count of
all-zero rows in the kernel's output, and whether an immediate second
launch on the same inputs gives the same bits (``diagnose``); nothing is
retried.

Phase 2 also holds K2 and K4 at the families' shapes: K2 at
phi-3-vision's prefill, q/k/v (1,32,1024,96) causal, whisper's encoder,
(4,8,1500,64) non-causal, and its cross attention, q (4,8,4,64) over
(4,8,1500,64) (the shapes phase 16 gives them), and one lane's encoder
and q (1,8,448,64) over (1,8,1500,64); K4 at phi-3's decode over (8,32,2048,96), whisper's
cross decode over all 1500 frames and qwen2-moe's (8,16,128) at G = 1;
two launches bit-equal, each timed beside SDPA with its bound (the
``*_d96`` and ``*_whisper_*`` records, whose launches are phase 16's:
the whisper records' by call shape, :func:`call_classes`).

Phase 2 also holds K5a/K5b at phase 18's training shapes
(``TRAIN_BWD_CASES``): phi-3-vision's q/k/v (2,32,4096,96) causal,
qwen2-moe's (2,16,4096,128) causal at G = 1, whisper's cross attention,
q (2,8,4096,64) over k/v (2,8,1500,64), and its encoder, (2,8,1500,64),
non-causal over the ragged key tail (1500 = 23 x 64 + 28), each with
the K2 output it starts from, against the plain versions, two launches
bit-equal, timed beside SDPA's whole backward with its bound (the
``*_d96``, ``*_d128``, ``*_whisper_train`` and ``*_whisper_enc_train``
records; K2 at the cross shape as a training forward,
``flash_attention_fwd_whisper_train``); small ragged cases at head dim
96 and at Sq != Sk join ``check_backward``'s.

Phase 2 also holds K5a/K5b at gemma3-12b's head dim 256, where the dK/dV
kernel's 8 warps split dK's and dV's columns over the two warps of each
key slice: small ragged cases (causal GQA 16/8, window 100 in bf16 and
fp32, non-causal Sq != Sk) in ``check_backward``, and phase 19's
microbatch of one sequence, q (1,16,4096,256) over k/v (1,8,4096,256),
causal with window 1024 (a local layer) and without (a global one), in
``TRAIN_BWD_CASES`` with K2's forward at both shapes (the ``*_d256_local``
and ``*_d256_global`` records; SDPA given the window's mask leaves its
fast path, so its ``is_causal`` time is printed beside the masked one);
K3 forward and backward at gemma3's training widths, (4096, 3840) and
its q- and k-norms' (65536, 256) and (32768, 256), the backward at every
training shape beside its plain version and autograd through
``F.rms_norm``.

Phase 2 also holds K1 and K2 at mistral-nemo-12b's head dim 128 (K1
over 8 lanes of 1600..2012 tokens whose tables lead with the same 12
physical pages, with its byte bound over the unique pages and over the
pages each lane reads; K2 at the three chunk shapes of phase 12: a
first chunk of 512, the warm lead chunk of 128 at offset 1408 over 1536
keys, a suffix chunk of 512 at offset 1536 over 2048 keys).

Phase 2 also holds K1, K2 and K4 at gemma3-12b's head dim 256 (K1 over
a global table of ~2000 tokens a lane and a wrapped 9-page ring with
window 1024, K2 at the 2048-token prefill with window 1024 and without,
K4 over a full 1024-slot ring) and times K3 at gemma3's widths (3840,
and 256 for q_norm/k_norm); phase 4 also serves reduced gemma3-12b on
ring pages, CUDA against CPU, past the ring wrap.

Phase 2 also holds K4 (decode attention), K6 (RWKV-6 WKV), K7 (Mamba-2
SSD scan) and K2 at head dim 80 against their plain versions, at small
shapes and at the full-width shapes of phases 7 and 8.  K4, split over
the cache and combined in a second kernel, is held with a ragged cache,
valid lengths 0, 1 and S+5 in one call and every lane inside the first
split, two launches bit-equal, and timed at zamba2's and tinyllama's
decode shapes.  K6 and K7, whose
bf16 routes run the chunked form on tensor cores in three CUDA launches
a call, are held elementwise at 1e-4 on small cases (lengths 1 to 1000
around the chunk of 64, two batch rows, a decay of about -4 per token,
rows 4 and 2 bytes off 16-byte alignment) and by ``SCAN_REL_NORM`` at
full width, where two launches must give bit-equal results and each
CUDA kernel's time per call is printed; where ``cuobjdump`` is found,
each of their bf16 kernels must show HMMA instructions.

Phase 2 also holds K5a/K5b at zamba2-2.7b's training shape, q/k/v
(2,32,4096,80) causal bf16 (two small head-dim-80 cases join
``check_backward``'s), against the plain backward with bf16 and fp32
operands, two launches bit-equal, timed beside SDPA's whole backward
(the ``*_d80`` records, whose launches are phase 14's); and the
``SSDScan``/``WKV`` Functions' gradients at (1,80,1000,64) /
(1,64,1000,64) and at a ragged 333 tokens of batch 2 against autograd
through the plain versions (``SCAN_GRAD_REL_NORM``), with the forward
kernel's and the backward's time at the training shapes (2,80,4096,64)
and (2,64,4096,64).

A kernel's ``launches`` in the JSON record is its count over the serve
(phases 3, 7, 8, 11, 12, 13, 16) and train (phases 5, 14, 15, 18, 19,
and rank 0's of phase 20) runs;
K3's are also printed by shape class; the ``*_d256`` records count phase
11's runs only, the forward ``*_d128`` records phase 12's mistral-nemo-12b
runs only, the ``*_d80`` backward records phase 14's, the forward
``*_d96`` records phase 16's phi-3-vision runs and the forward
``*_whisper_*`` records its whisper run; the backward ``*_d96`` records
phase 18's phi-3 runs, the backward ``*_d128`` records its qwen2-moe run
and the ``*_whisper_*train`` records its whisper run by call shape, the
``*_d256_local*`` and ``*_d256_global*`` records phase 19's run by call
shape.
``ab_train`` (not run by ``main``) runs phase 5 and K3's timings
for a second checkout and this one in turns on one card; ``ab_serve``
does the same for phase 3's mean TTFT and decode step.  Those runs also fail if a
flash-attention wrapper copied an operand to align its rows for the
tensor-core kernels' ``cp.async`` (the model's layouts need no copy).  The second-to-last lines are
the kernels' JSON record and the card's name and power limit; the last
line is the run's JSON verdict.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12         # dense bf16 tensor cores
H100_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
TIE_GAP = 2e-2                   # logit gap below which a token may flip


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def short_name(demangled: str) -> str:
    """A demangled kernel name without its namespace and parameters, as
    ``c++filt`` ("(anonymous namespace)::f<64>(...)") or ``cu++filt``
    ("<unnamed>::f<(int)64>(...)") prints it."""
    for noise in ("(anonymous namespace)::", "<unnamed>::", "(int)"):
        demangled = demangled.replace(noise, "")
    return demangled.split("(")[0]


def print_ptxas(name: str, log: str) -> None:
    """One line per kernel of nvcc's ``-Xptxas -v`` report: its name
    (demangled by ``cu++filt`` or ``c++filt`` where found), registers and
    spills."""
    import shutil
    entries, fn, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill" in line:
            spills = line.split(":", 1)[-1].strip()
        elif "registers" in line and fn is not None:
            entries.append((fn, line.split(":", 1)[1].strip(), spills))
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    names = [fn for fn, _, _ in entries]
    if tool and names:
        out = subprocess.run([tool], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [short_name(n) for n in out.stdout.splitlines()]
    for short, (_, regs, spill) in zip(names, entries):
        print(f"[ptxas {name}] {short}: {regs}; {spill}")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py: run it from "
             "the root of a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build()
    for name, log in reports.items():
        print_ptxas(name, log)
    print(f"[build] nvcc {sorted(reports) or 'cached'} "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    records = check_kernels(torch)
    launches = serve_full(torch)
    profile_serve(torch)
    parity_reduced(torch)
    for name, n in train_full(torch).items():
        launches[name] = launches.get(name, 0) + n
    parity_train_reduced(torch)
    for arch in ("zamba2-2.7b", "rwkv6-7b"):
        for name, n in serve_dense_full(torch, arch).items():
            launches[name] = launches.get(name, 0) + n
    parity_dense_reduced(torch)
    history_loop(torch)
    gemma3 = serve_gemma3_full(torch)
    for name, n in gemma3.items():
        launches[name] = launches.get(name, 0) + n
        launches[f"{name}_d256"] = n
    mistral, mistral_d128 = serve_mistral_full(torch)
    for name, n in mistral.items():
        launches[name] = launches.get(name, 0) + n
    launches.update(mistral_d128)
    for name, n in serve_park(torch).items():
        launches[name] = launches.get(name, 0) + n
    zamba2 = train_zamba2_full(torch)
    for name, n in list(zamba2.items()) + list(train_rwkv6_full(torch)
                                               .items()):
        launches[name] = launches.get(name, 0) + n
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        launches[f"{name}_d80"] = zamba2[name]
    families, family_records = serve_families_full(torch)
    for name, n in families.items():
        launches[name] = launches.get(name, 0) + n
    launches.update(family_records)
    parity_families_reduced(torch)
    trained, trained_records = train_families_full(torch)
    for name, n in trained.items():
        launches[name] = launches.get(name, 0) + n
    launches.update(trained_records)
    trained, trained_records = train_gemma3_full(torch)
    for name, n in trained.items():
        launches[name] = launches.get(name, 0) + n
    launches.update(trained_records)
    for name, n in train_sharded(torch).items():
        launches[name] = launches.get(name, 0) + n
    for rec in records:
        rec["launches"] = launches.get(rec["name"])
    print(f"[launches] rmsnorm by shape class over the main paths: "
          f"{RMS_LAUNCHES} (decode: a decode step's; prefill: a prompt's "
          f"or chunk's; train: a training microbatch's 4096 or 8192 rows, "
          f"phi-3-vision's over 3072 and gemma3's over 3840 and 256 apart)",
          flush=True)
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def timed_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the device time of one call, in ms.  Each
    repetition enqueues ``iters`` calls behind a device-side sleep long
    enough to cover their host launch time, so the two CUDA events bracket
    back-to-back device work and not the Python launch overhead (which a
    naive event loop at these sizes measures)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = 4 * iters * (time.perf_counter() - t0)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(max(host_s, 0.01), 2.0) * 2e9))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[reps // 2]


def compare(torch, name, got, want, atol, rtol, gate=True, rerun=None):
    """Elementwise |got - want| <= atol + rtol |want|; fails unless
    ``gate`` is False (then the worst err/tol is printed for information).
    ``rerun`` launches the kernel again on the same inputs and returns what
    ``got`` is; on a failure (a gated disagreement or a non-finite output)
    :func:`diagnose` prints what tells the failure's kind.  Returns the
    max abs error."""
    raw = got
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        diagnose(torch, name, raw, want, None, rerun)
        fail(f"{name}: kernel output not finite")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-6)).max())
    bad = err > atol + rtol * want.abs()
    used = float((err / (atol + rtol * want.abs())).max())
    ok = used <= 1.0
    verdict = ("ok" if ok else "FAIL") if gate else "not gated"
    print(f"[kernel] {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"tol=atol {atol:g} + rtol {rtol:g}*|ref|, worst err/tol="
          f"{used:.3f} -> {verdict}", flush=True)
    if gate and not ok:
        diagnose(torch, name, raw, want, bad, rerun)
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs


def diagnose(torch, name, got, want, bad, rerun):
    """What a failed comparison prints before the run stops: the first 8
    bad elements by (row, column) of the last dim, with the kernel's and
    the plain version's values; the count of rows of ``got`` that are all
    zero; and whether a second launch right after, on the same inputs,
    returns the same bits (a kernel that races or reads uninitialised
    memory usually does not).  Nothing here retries the check."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, got.shape[-1])
    if bad is None:
        bad = ~torch.isfinite(g)
    idx = bad.reshape(g.shape).nonzero()[:8].tolist()
    print(f"[diagnose] {name}: {int(bad.sum())} bad of {g.numel()} "
          f"elements; first (row, col) got/want: "
          + ", ".join(f"({r}, {c}) {float(g[r, c]):.6g}/{float(w[r, c]):.6g}"
                      for r, c in idx), flush=True)
    zero_rows = int((g == 0).all(-1).sum())
    print(f"[diagnose] {name}: rows of the kernel's output that are all "
          f"zero: {zero_rows} of {g.shape[0]} (the plain version's: "
          f"{int((w == 0).all(-1).sum())})", flush=True)
    if rerun is None:
        print(f"[diagnose] {name}: no second launch (the check gives none)",
              flush=True)
        return
    torch.cuda.synchronize()
    again = rerun()
    torch.cuda.synchronize()
    same = bool(torch.equal(again, got))
    now = float((again.float() - want.float()).abs().max())
    print(f"[diagnose] {name}: an immediate second launch on the same "
          f"inputs gives {'the same' if same else 'a different'} result "
          f"(its max_abs against the plain version {now:.3e})", flush=True)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextmanager
def row_copies():
    """Count the operands that the flash wrappers copy for the tensor-core
    kernels' 16-byte ``cp.async`` rows (``_rows_aligned``) while the block
    runs; the model's layouts need none."""
    from repro_torch.kernels import flash_attention as fa
    plain, seen = fa._rows_aligned, {"copies": 0}

    def counting(*ts):
        out = plain(*ts)
        seen["copies"] += sum(a is not b for a, b in zip(ts, out))
        return out

    fa._rows_aligned = counting
    try:
        yield seen
    finally:
        fa._rows_aligned = plain


def no_row_copies(what, seen):
    print(f"[{what}] operands copied for cp.async alignment: "
          f"{seen['copies']}", flush=True)
    if seen["copies"]:
        fail(f"{what}: the main path copied operands for the flash kernels")


def check_kernels(torch):
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_ref)
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref,
                                                     split_pages)
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    # tolerances (atol, rtol): each side rounds its bf16 output once from
    # fp32 values that differ only in summation order (~1e-6), so the two
    # differ by at most one bf16 ulp, which is at most 2^-7 of |ref|; atol
    # covers the fp32 difference near zero.  fp32 outputs differ by
    # summation order only.
    tol = {bf16: (1e-4, 2.0 ** -7), f32: (2e-5, 2e-5)}

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    records = []

    # -- K3 rmsnorm, forward and backward ----------------------------------
    records += check_rmsnorm(torch, randn, tol)

    # -- K1 paged attention -------------------------------------------------
    def paged_case(b, h, kvh, d, pool, maxp, vlens, dtype, window=0,
                   ring=False, empty_lane=False):
        kp, vp = randn(pool + 1, 128, kvh, d, dtype=dtype), \
            randn(pool + 1, 128, kvh, d, dtype=dtype)
        perm = torch.randperm(pool, generator=gen, device=dev)
        table = torch.full((b, maxp), -1, dtype=torch.int32, device=dev)
        used = 0
        for i, vl in enumerate(vlens):
            n = min(maxp, -(-vl // 128)) if not ring else maxp
            if empty_lane and i == b - 1:
                n = 0
            table[i, :n] = perm[used:used + n].int()
            used += n
        vlen = torch.tensor(vlens, dtype=torch.int32, device=dev)
        q = randn(b, h, d, dtype=dtype)
        return q, kp, vp, table, vlen

    errs = []
    cases = [
        ("small b=3 h=6/2 d=64", (3, 6, 2, 64, 16, 4, [300, 129, 1]), {}),
        ("reduced h=4/4 d=16 all -1 lane",
         (3, 4, 4, 16, 12, 2, [200, 77, 1]), dict(empty_lane=True)),
        ("small fp32 h=8/2 d=32", (2, 8, 2, 32, 8, 3, [380, 5]),
         dict(dtype=f32)),
        ("window=200", (2, 4, 2, 64, 12, 4, [450, 130]), dict(window=200)),
        ("ring+window=200 ring=3", (2, 4, 2, 64, 12, 3, [1000, 300]),
         dict(window=200, ring=True)),
        # lanes of 1, 4 and 16 live pages and an all -1 lane: splits past a
        # lane's length, and a lane with no live split at all
        ("live pages 1/4/16 + all -1 lane h=32/4 d=64", (4, 32, 4, 64, 32, 16,
                                                        [128, 512, 2048, 1]),
         dict(empty_lane=True)),
        ("tinyllama b=8 h=32/4 d=64", (8, 32, 4, 64, 128, 16,
                                       [898, 693, 572, 340, 376, 120, 1, 1]),
         dict(empty_lane=True)),
    ]
    for label, (b, h, kvh, d, pool, maxp, vlens), kw in cases:
        dtype = kw.pop("dtype", bf16)
        window, ring = kw.get("window", 0), kw.get("ring", False)
        q, kp, vp, table, vlen = paged_case(b, h, kvh, d, pool, maxp, vlens,
                                            dtype, **kw)
        got = paged_attention(q, kp, vp, table, vlen, window=window,
                              ring=ring)
        want = paged_attention_ref(q, kp, vp, table, vlen, window=window,
                                   ring=ring)
        errs.append(compare(
            torch, f"paged_attention {label}", got, want, *tol[dtype],
            rerun=lambda: paged_attention(q, kp, vp, table, vlen,
                                          window=window, ring=ring)))
        if kw.get("empty_lane") and float(got[-1].abs().max()) != 0.0:
            fail("paged_attention: an all -1 lane must return zeros")
    pps, splits = split_pages(b, kvh, maxp,
                              torch.cuda.get_device_properties(0)
                              .multi_processor_count)
    print(f"[kernel] paged_attention split at the serving shape: B={b} "
          f"KV={kvh} table width {maxp} -> {splits} splits of {pps} "
          f"page(s), {b * kvh * splits} blocks", flush=True)
    # time at the tinyllama decode shape of the serving run (last case)
    ms = timed_ms(torch, lambda: paged_attention(q, kp, vp, table, vlen))
    plain = timed_ms(torch, lambda: paged_attention_ref(q, kp, vp, table,
                                                        vlen))

    def sdpa_gathered():
        safe = table.clamp(min=0).long()
        k = kp[safe].flatten(1, 2).transpose(1, 2)      # (B, KV, S, D)
        v = vp[safe].flatten(1, 2).transpose(1, 2)
        slot = torch.arange(k.shape[2], device=dev)
        mask = ((slot[None, :] < vlen[:, None])
                & table.repeat_interleave(128, dim=1).ge(0))
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask[:, None, None],
            enable_gqa=True)

    lib = timed_ms(torch, sdpa_gathered)
    # the function reads each valid token's K and V once (a token's KV x D
    # values are contiguous, so no partial page need be read) and attends
    # those tokens only; an all -1 lane reads and attends nothing
    live_pages = (table >= 0).sum(1)
    attended = int(torch.minimum(vlen, live_pages * 128).sum())
    nbytes = (2 * q.numel() * 2 + table.numel() * 4 + vlen.numel() * 4
              + 2 * attended * 4 * 64 * 2)
    b_ms, b_by = bound(nbytes, 4 * 32 * 64 * attended, H100_BF16_FLOPS)
    records.append(dict(name="paged_attention", route="cuda",
                        source="src/repro_torch/csrc/paged_attention.cu",
                        replaces="src/repro/kernels/paged_attention.py:111",
                        max_abs_err=max(errs), ms=ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                        shape="B=8 H=32 KV=4 D=64, vlen "
                              f"{[int(v) for v in vlen]}"))

    # -- K2 flash attention forward -------------------------------------------
    # fp32 cases elementwise against the plain version; bf16 cases (the
    # tensor-core kernel) by relative norm, see check_fwd
    errs = []
    fcases = [
        ("small causal ragged b=2 h=4/2 s=200 d=64", 2, 4, 2, 200, 200, 64,
         True, 0, 0, bf16),
        ("windowed=64 h=4/4 s=256 d=16", 1, 4, 4, 256, 256, 16, True, 64, 0,
         bf16),
        ("non-causal fp32 h=2/1 s=130 d=32", 1, 2, 1, 130, 130, 32, False, 0,
         0, f32),
        ("q_offset=512 h=32/4 sq=256 sk=768 d=64", 1, 32, 4, 256, 768, 64,
         True, 0, 512, bf16),
        ("d=128 causal s=192", 1, 2, 1, 192, 192, 128, True, 0, 0, bf16),
        ("d=80 fp32 q_offset=40 h=4/2 sq=90 sk=130", 1, 4, 2, 90, 130, 80,
         True, 0, 40, f32),
        ("d=256 fp32 windowed=50 h=4/2 s=200", 1, 4, 2, 200, 200, 256, True,
         50, 0, f32),
        ("d=80 windowed=50 ragged h=4/2 sq=70 sk=170 q_offset=100", 1, 4, 2,
         70, 170, 80, True, 50, 100, bf16),
        ("d=32 non-causal h=4/1 sq=100 sk=300", 1, 4, 1, 100, 300, 32, False,
         0, 0, bf16),
        ("zamba2 prefill d=80 h=32/32 s=1000", 1, 32, 32, 1000, 1000, 80,
         True, 0, 0, bf16),
        ("tinyllama native s=512 h=32/4 d=64", 1, 32, 4, 512, 512, 64, True,
         0, 0, bf16),
        ("tinyllama chunk q_offset=512 sq=512 sk=1024", 1, 32, 4, 512, 1024,
         64, True, 0, 512, bf16),
    ]
    for (label, b, h, kvh, sq, sk, d, causal, window, off, dtype) in fcases:
        q = randn(b, sq, h, d, dtype=dtype).transpose(1, 2)   # model layout
        k = randn(b, sk, kvh, d, dtype=dtype).transpose(1, 2)
        v = randn(b, sk, kvh, d, dtype=dtype).transpose(1, 2)
        errs.append(check_fwd(torch, label, q, k, v, dict(
            causal=causal, window=window, q_offset=off), tol)[0])
        if label.startswith("zamba2"):
            time_fwd_d80(torch, q, k, v)
    # timed at the chunked-prefill shape of the serving run (last case)
    ms = timed_ms(torch, lambda: flash_attention_fwd(q, k, v, q_offset=off))
    plain = timed_ms(torch, lambda: flash_attention_fwd_ref(
        q, k, v, q_offset=off, operand_dtype=bf16))
    kpos = torch.arange(sk, device=dev)
    qpos = off + torch.arange(sq, device=dev)
    mask = kpos[None, :] <= qpos[:, None]
    lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))
    pairs = int(mask.sum())
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * sq * h
    b_ms, b_by = bound(nbytes, 4 * h * d * pairs, H100_BF16_FLOPS)
    records.append(dict(name="flash_attention_fwd", route="cuda",
                        source="src/repro_torch/csrc/flash_attention_fwd.cu",
                        replaces="src/repro/kernels/flash_attention.py:96",
                        max_abs_err=max(errs), ms=ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                        shape=f"B=1 H=32 KV=4 D=64 Sq={sq} Sk={sk} "
                              f"q_offset={off} causal; plain_ms is the "
                              "plain version with bf16 operands"))
    bwd_records, fwd_errs = check_backward(torch, randn, tol)
    records[-1]["max_abs_err"] = max(errs + fwd_errs)
    records += bwd_records
    check_functions(torch, randn)
    records += check_backward_shapes(torch, randn, tol)
    records += check_dense_kernels(torch, randn, tol)
    check_scan_grads(torch, randn)
    records += check_head_dim_256(torch, randn, tol)
    records += check_head_dim_128(torch, randn, tol)
    records += check_families_kernels(torch, randn, tol)
    for rec in records:
        lib_txt = ("none" if rec["library_ms"] is None
                   else f"{rec['library_ms']:.4f} ms")
        print(f"[time] {rec['name']} ({rec['shape']}): kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
              f"{lib_txt}, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})", flush=True)
    return records


# K3's shape classes on the main paths: a decode step's 8 rows and a
# prefill's ~1000 rows at the four widths (tinyllama 2048, zamba2 2560 and
# its Mamba-2 inner norm 5120, rwkv6 4096), gemma3-12b's 3840 (8 rows, and
# a 2048-token prompt) and its q_norm over 256-wide heads (8 lanes x 16
# heads a decode step, 2048 tokens x 16 heads a prompt), phi-3-vision's
# training norms over 3072 (a microbatch of one sequence, 4096 rows, and
# of two, 8192), gemma3's training norms of a microbatch of one sequence
# (4096 rows of 3840, and its q_norm and k_norm over 4096 x 16 and 4096 x
# 8 heads of 256), and a training norm's 8192 rows of 2048 (B=2 x
# S=4096), last: its times are the forward record's
RMS_CLASSES = ([("decode", 8, d) for d in (2048, 2560, 4096, 5120, 3840)]
               + [("decode", 128, 256)]
               + [("prefill", 1000, d) for d in (2048, 2560, 4096, 5120)]
               + [("prefill", 2048, 3840), ("prefill", 32768, 256)]
               + [("train", 4096, 3072), ("train", 8192, 3072),
                  ("train", 4096, 3840), ("train", 65536, 256),
                  ("train", 32768, 256), ("train", 8192, 2048)])
# K3's launches on the main paths by shape class, summed by the phases
# that drive them (phase 18's phi-3-vision runs under "train 3072",
# phase 19's gemma3 run under "train gemma3")
RMS_LAUNCHES = {"decode": 0, "prefill": 0, "train": 0, "train 3072": 0,
                "train gemma3": 0}
# K3 backward: fp32 sums of dy * x * r over 8192 rows in another order
# than the plain version's (per program, then the partials in order)
RMS_DGAIN_REL_NORM = 1e-4


def l2_sets(torch, set_bytes):
    """How many input sets of ``set_bytes`` hold twice the card's L2
    together (at least 2), so that timing calls that cycle through them
    read HBM and not L2."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(2, -(-2 * l2 // set_bytes))


def rms_bound(rows, d, itemsize, tensors, vectors, ops_per_element):
    """K3's bound: ``tensors`` row tensors of ``rows`` x ``d`` (x and y;
    x, dy and dx) and ``vectors`` of ``d`` (the gain; and dgain) moved
    once each, against the fp32 operations on the SIMT cores."""
    nbytes = (tensors * rows * d + vectors * d) * itemsize
    return bound(nbytes, ops_per_element * rows * d, H100_FP32_FLOPS)


def cuda_kernels_per_call(torch, fn):
    """The number of CUDA kernels one call of ``fn`` launches, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA"))


def time_rmsnorm_classes(torch, rms, gen):
    """K3's forward at every shape class (bf16 x and gain, as the model
    keeps them): kernel, plain and ``F.rms_norm`` ms beside the bound;
    and the plain backward at the training shape: its ms and the CUDA
    kernels it launches a call.  Each timed call takes the next of
    ``l2_sets`` input sets, which together hold twice the card's L2, so
    a call reads its input from HBM as the path does and not from L2.
    ``rms`` is a tree's ``repro_torch.kernels.rmsnorm`` module.  Printed;
    returns the record fields of the training shape."""
    import itertools
    import torch.nn.functional as F
    dev = torch.device("cuda")
    out = {}
    for label, rows, d in RMS_CLASSES:
        n = l2_sets(torch, rows * d * 2)
        xs = torch.randn((n, rows, d), generator=gen,
                         device=dev).to(torch.bfloat16)
        gs = (torch.randn((n, d), generator=gen, device=dev) * 0.1).to(xs.dtype)
        ws = 1.0 + gs
        sets = list(zip(xs, gs, ws))
        x, g, _ = sets[-1]

        def cycled(fn):
            it = itertools.cycle(sets)
            return lambda: fn(*next(it))
        ms = timed_ms(torch, cycled(lambda x, g, w: rms.rmsnorm(x, g)))
        plain = timed_ms(torch, cycled(lambda x, g, w: rms.rmsnorm_ref(x, g)))
        lib = timed_ms(torch, cycled(lambda x, g, w: F.rms_norm(
            x, (d,), weight=w, eps=1e-6)))
        b_ms, b_by = rms_bound(rows, d, 2, 2, 1, 4)
        print(f"[time] rmsnorm {label} x ({rows}, {d}) bf16: kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms "
              f"(F.rms_norm), bound {b_ms:.6f} ms ({b_by}), share of bound "
              f"{b_ms / ms:.3f}", flush=True)
        out = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                   bound_by=b_by)
    dy = torch.randn((rows, d), generator=gen, device=dev).to(x.dtype)
    plain = timed_ms(torch, lambda: rms.rmsnorm_bwd_ref(dy, x, g), iters=3,
                     reps=3)
    n = cuda_kernels_per_call(torch, lambda: rms.rmsnorm_bwd_ref(dy, x, g))
    print(f"[time] rmsnorm_bwd_ref (plain backward) x ({rows}, {d}) bf16: "
          f"{plain:.4f} ms, {n} CUDA kernels a call", flush=True)
    return out


def time_rmsnorm_bwd(torch, rms, dy, x, g):
    """K3's backward on (dy, x, g): the kernel's ms, the plain version's,
    autograd's backward through ``F.rms_norm`` (the library call) and the
    bound."""
    import torch.nn.functional as F
    rows, d = x.shape
    ms = timed_ms(torch, lambda: rms.rmsnorm_bwd(dy, x, g))
    plain = timed_ms(torch, lambda: rms.rmsnorm_bwd_ref(dy, x, g), iters=3,
                     reps=3)
    xl, gl = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    yl = F.rms_norm(xl, (d,), weight=1.0 + gl, eps=1e-6)
    lib = timed_ms(torch, lambda: torch.autograd.grad(
        yl, (xl, gl), dy, retain_graph=True))
    return (ms, plain, lib) + rms_bound(rows, d, 2, 3, 2, 12)


def check_rmsnorm(torch, randn, tol):
    """K3's forward against ``rmsnorm_ref`` over the paths' shapes, and its
    backward against ``rmsnorm_bwd_ref``: dx elementwise (both fp32 from
    the same inputs, rounded once: one bf16 ulp), dgain elementwise in the
    gain's bf16 and, from an fp32 copy of the same gain, by relative norm
    (``RMS_DGAIN_REL_NORM``); two backward launches bit-equal at the
    training shapes.  The forward timed at every shape class, the
    backward at the training shapes beside its plain version and
    autograd through ``F.rms_norm`` (the record's at 8192 x 2048; the
    others printed: phi-3's 3072, gemma3's 3840 and its q- and k-norms
    over 65536 and 32768 rows of 256, whose dgain sums every row).
    Returns the forward's and the backward's records."""
    from repro_torch.kernels import rmsnorm as rms
    bf16, f32 = torch.bfloat16, torch.float32
    errs = []
    # 8192 rows of 2048: a norm of the training path (B=2 x S=4096)
    # 1000 and 8 rows of 2560 (zamba2), 5120 (its Mamba-2 inner norm) and
    # 4096 (rwkv6): a ragged prefill and a decode step of the dense path,
    # 2560 and 5120 through the kernel's masked tail; gemma3-12b's 3840
    # (a 2048-token prompt, a decode step) and its q_norm/k_norm over
    # 256-wide heads (2048 tokens x 16 heads, 8 lanes x 16 heads);
    # phi-3-vision's training microbatches of one and two sequences at
    # 3072; gemma3's training microbatch of one sequence (4096 rows of
    # 3840, its q_norm's 4096 x 16 rows of 256)
    for rows, d, dtype in ((33, 128, f32), (8, 64, bf16), (8, 2048, bf16),
                           (512, 2048, bf16), (8192, 2048, bf16),
                           (4096, 3072, bf16), (8192, 3072, bf16),
                           (1000, 2560, bf16), (8, 2560, bf16),
                           (1000, 5120, bf16), (8, 5120, bf16),
                           (1000, 4096, bf16), (8, 4096, bf16),
                           (2048, 3840, bf16), (8, 3840, bf16),
                           (32768, 256, bf16), (128, 256, bf16),
                           (4096, 3840, bf16), (65536, 256, bf16)):
        x, g = randn(rows, d, dtype=dtype), randn(d, dtype=f32, scale=0.1)
        errs.append(compare(torch, f"rmsnorm rows={rows} d={d} {dtype}",
                            rms.rmsnorm(x, g), rms.rmsnorm_ref(x, g),
                            *tol[dtype], rerun=lambda: rms.rmsnorm(x, g)))
    fwd = dict(name="rmsnorm", route="triton",
               source="src/repro_torch/kernels/rmsnorm.py",
               replaces="src/repro/kernels/rmsnorm.py:24",
               max_abs_err=max(errs), shape="x (8192, 2048) bf16")
    fwd.update(time_rmsnorm_classes(torch, rms, torch.Generator(
        device="cuda").manual_seed(11)))

    errs = []
    for rows, d, dtype in ((8192, 2048, bf16), (4096, 3072, bf16),
                           (8192, 3072, bf16), (4096, 3840, bf16),
                           (65536, 256, bf16), (32768, 256, bf16),
                           (1000, 2560, bf16), (1000, 5120, bf16),
                           (33, 128, f32)):
        x, dy = randn(rows, d, dtype=dtype), randn(rows, d, dtype=dtype)
        g = randn(d, dtype=dtype, scale=0.1)
        label = f"rows={rows} d={d} {dtype}"
        dx, dg = rms.rmsnorm_bwd(dy, x, g)
        want_dx, want_dg = rms.rmsnorm_bwd_ref(dy, x, g)
        errs.append(compare(torch, f"rmsnorm_bwd dx {label}", dx, want_dx,
                            *tol[dtype],
                            rerun=lambda: rms.rmsnorm_bwd(dy, x, g)[0]))
        compare(torch, f"rmsnorm_bwd dgain {label}", dg, want_dg, *tol[dtype],
                rerun=lambda: rms.rmsnorm_bwd(dy, x, g)[1])
        if dtype == bf16:
            g32 = g.float()
            rel_norm(torch, f"rmsnorm_bwd dgain {label}, fp32 gain",
                     rms.rmsnorm_bwd(dy, x, g32)[1],
                     rms.rmsnorm_bwd_ref(dy, x, g32)[1], RMS_DGAIN_REL_NORM)
        if rows < 4096:
            continue
        # the training shapes
        same_twice(torch, f"rmsnorm_bwd {label}",
                   lambda: rms.rmsnorm_bwd(dy, x, g))
        t = time_rmsnorm_bwd(torch, rms, dy, x, g)
        print(f"[time] rmsnorm_bwd x, dy ({rows}, {d}) bf16: kernel "
              f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, library {t[2]:.4f} ms "
              f"(autograd through F.rms_norm), bound {t[3]:.6f} ms ({t[4]}), "
              f"share of bound {t[3] / t[0]:.3f} | {card_line()}", flush=True)
        if (rows, d) == (8192, 2048):
            ms, plain, lib, b_ms, b_by = t
            kernel_split(torch, lambda: rms.rmsnorm_bwd(dy, x, g),
                         f"rmsnorm_bwd {label}")
            shape = f"x, dy ({rows}, {d}) bf16"
    bwd = dict(name="rmsnorm_bwd", route="triton",
               source="src/repro_torch/kernels/rmsnorm.py",
               replaces="src/repro/models/layers.py:90",
               max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib,
               shape=shape + "; replaces XLA's autodiff of the reference's "
                             "rms_norm (no Pallas kernel); library_ms is "
                             "autograd's backward through F.rms_norm")
    print(f"[time] rmsnorm_bwd {shape}: share of bound {b_ms / ms:.3f}, "
          f"kernel / plain {ms / plain:.4f}", flush=True)
    return [fwd, bwd]


# bf16 forward: the tensor-core kernel rounds p to bf16 where it becomes
# the operand of p.V.  Against the plain version that rounds at the same
# place over the kernel's key tiles they differ by fp32 summation order and
# the rare bf16 rounding that flips with it; against the fp32 plain version
# by the rounding itself (relative norm 1.1e-3 to 1.4e-3 on the CPU at four
# shapes) and the output's own bf16 rounding, so that limit is ~4x that.
FWD_KERNEL_REL_NORM = 1e-3
FWD_FP32_REL_NORM = 1e-2


def check_fwd(torch, label, q, k, v, kw, tol):
    """K2 on one case.  lse elementwise at (1e-4, 1e-5) against the fp32
    plain version.  fp32 inputs (the SIMT kernel): o elementwise at the
    fp32 tolerance.  bf16 inputs (the tensor-core kernel): o by relative
    norm against the plain version with bf16 operands and the kernel's key
    tile (``FWD_KERNEL_REL_NORM``, the worst elementwise err/tol printed
    for information) and against the fp32 plain version
    (``FWD_FP32_REL_NORM``), SDPA's relative norm to the latter printed
    beside it.  Returns the max abs error against the first plain
    version, and the kernel's o and lse."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        _visible, flash_attention_fwd, flash_attention_fwd_ref, fwd_block_k)
    name = f"flash_attention_fwd o {label}"
    o, lse = flash_attention_fwd(q, k, v, **kw)
    o_f, lse_f = flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                         **kw)
    compare(torch, f"flash_attention_fwd lse {label}", lse, lse_f, 1e-4,
            1e-5, rerun=lambda: flash_attention_fwd(q, k, v, **kw)[1])
    if q.dtype == torch.float32:
        return compare(torch, name, o, o_f, *tol[torch.float32],
                       rerun=lambda: flash_attention_fwd(q, k, v, **kw)[0]), \
            o, lse
    del lse_f
    o_b, _ = flash_attention_fwd_ref(q, k, v, operand_dtype=torch.bfloat16,
                                     block_k=fwd_block_k(q.shape[-1]), **kw)
    worst = rel_norm(torch, f"{name} vs plain (bf16 operands)", o, o_b,
                     FWD_KERNEL_REL_NORM)
    compare(torch, f"{name} vs plain (bf16 operands), information only", o,
            o_b, *tol[torch.bfloat16], gate=False)
    del o_b
    torch.cuda.empty_cache()
    rel_norm(torch, f"{name} vs plain (fp32)", o, o_f, FWD_FP32_REL_NORM)
    ok = _visible(q.shape[2], k.shape[2], kw["causal"], kw["window"],
                  kw["q_offset"], q.device)
    # on contiguous copies: on rows 4 elements off 16-byte alignment SDPA
    # returned a wrong result (relative norm 1.1) on the card
    ref = F.scaled_dot_product_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), attn_mask=ok,
        enable_gqa=True)
    err = float((o.float() - o_f).norm() / o_f.norm())
    lib = float((ref.float() - o_f).norm() / o_f.norm())
    print(f"[kernel] {name}: relative norm to the fp32 plain version: "
          f"kernel {err:.3e}, SDPA {lib:.3e}", flush=True)
    del o_f, ref
    torch.cuda.empty_cache()
    return worst, o, lse


def attended_pairs(sq, sk, causal, window=0):
    """The (query, key) pairs one head attends with no query offset:
    causal (Sq = Sk) within ``window`` keys of each query (0: all), or
    every pair."""
    if not causal:
        return sq * sk
    w = window if 0 < window < sq else sq
    return w * (w + 1) // 2 + (sq - w) * w


def sdpa_mask(torch, s, window, dev):
    """SDPA's boolean (S, S) mask of causal attention within ``window``
    keys; a mask takes SDPA off its ``is_causal`` fast path."""
    return torch.ones(s, s, dtype=torch.bool, device=dev).tril().triu(
        -(window - 1))


def _fwd_times(torch, q, k, v, causal, window=0):
    """K2's time (no query offset; causal only at Sq = Sk, where
    ``window`` may limit the keys), its plain version's (bf16 operands),
    SDPA's on contiguous copies (given the window's mask where there is
    one), and the bound from what the inputs need."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_ref, fwd_block_k)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    assert sq == sk or not causal
    kw = dict(causal=causal, window=window)
    ms = timed_ms(torch, lambda: flash_attention_fwd(q, k, v, **kw))
    plain = timed_ms(torch, lambda: flash_attention_fwd_ref(
        q, k, v, operand_dtype=torch.bfloat16, block_k=fwd_block_k(d),
        **kw), iters=3, reps=3)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    mask = sdpa_mask(torch, sq, window, q.device) if window else None
    lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
        qc, kc, vc, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True))
    pairs = b * h * attended_pairs(sq, sk, causal, window)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * h * sq
    b_ms, b_by = bound(nbytes, 4 * d * pairs, H100_BF16_FLOPS)
    return ms, plain, lib, b_ms, b_by


def _decode_times(torch, q, k, v, vlen):
    """K4's time, its plain version's, SDPA's (with a length mask where a
    lane attends to fewer than all S keys), and the bound over the keys
    the valid lengths cover."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    b, kvh, s, d = k.shape
    h = q.shape[1]
    ms = timed_ms(torch, lambda: decode_attention(q, k, v, vlen))
    plain = timed_ms(torch, lambda: decode_attention_ref(q, k, v, vlen))
    mask = torch.arange(s, device=q.device)[None, :] < vlen[:, None]
    mask = None if bool(mask.all()) else mask[:, None, None]
    lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True))
    attended = int(vlen.clamp(max=s).sum())
    nbytes = 2 * q.numel() * 2 + vlen.numel() * 4 + 2 * attended * kvh * d * 2
    b_ms, b_by = bound(nbytes, 4 * h * d * attended, H100_BF16_FLOPS)
    return ms, plain, lib, b_ms, b_by


def time_fwd_d80(torch, q, k, v):
    """K2 at zamba2's prefill shape (head dim 80): one ``[time]`` line."""
    b, h, sq, d = q.shape
    ms, plain, lib, b_ms, b_by = _fwd_times(torch, q, k, v, causal=True)
    print(f"[time] flash_attention_fwd at zamba2's prefill shape (B={b} "
          f"H={h} KV={k.shape[1]} D={d} S={sq} causal): kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms (bf16 operands), library {lib:.4f} ms "
          f"(SDPA), bound {b_ms:.4f} ms ({b_by})", flush=True)


# ---------------------------------------------------------------------------
# phase 2, dense path: K4, K6, K7 against their plain versions
# ---------------------------------------------------------------------------

# K6/K7 at the full-width shapes: both sides compute in fp32 from the same
# inputs (the kernels' fp32 operands split into two TF32 parts), the bf16
# kernels in chunks of 64 and the plain versions in chunks of 128: another
# summation order over 1000 tokens; the gate is the relative norm
SCAN_REL_NORM = 2e-3


def check_dense_kernels(torch, randn, tol):
    """K4 on fp32 copies (the plain version rounds probabilities to bf16 as
    the reference does; the kernel keeps them in fp32), K6 and K7 on the
    same inputs (both compute in fp32), after counting the tensor-core
    instructions of the bf16 K6 and K7 kernels (the chunk and inter-chunk
    launches at four head dims).  Returns their records."""
    tensor_core_sass({"ssd_scan": 8, "rwkv6_scan": 8})
    return [check_decode(torch, randn, tol), check_ssd(torch, randn),
            check_wkv(torch, randn)]


def rel_norm(torch, name, got, want, limit):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output not finite")
    err = float((got - want).norm() / want.norm())
    worst = float((got - want).abs().max())
    ok = err <= limit
    print(f"[kernel] {name}: relative norm {err:.3e} (limit {limit:g}), "
          f"max_abs={worst:.3e} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return worst


def check_decode(torch, randn, tol):
    """K4 against ``decode_attention_ref`` on fp32 copies, at the
    unchanged tolerance: the earlier six cases, a ragged S (1000, not a
    whole number of splits), valid lengths 0, 1 and S+5 in one call, and
    every lane inside the first split at zamba2's shape; a lane of valid
    length 0 must return exact zeros and two launches must be bit-equal.
    Timed at zamba2's decode shape (the record) and tinyllama's G = 8."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref,
                                                      split_keys)
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    kps, splits = split_keys(8, 32, 2048, torch.cuda.get_device_properties(
        0).multi_processor_count)
    print(f"[kernel] decode_attention split at zamba2's decode shape: B=8 "
          f"KV=32 S=2048 -> {splits} splits of {kps} keys, "
          f"{8 * 32 * splits} blocks", flush=True)
    cases = [
        ("small fp32 h=8/2 s=300 d=32", 2, 8, 2, 300, 32, [300, 17], f32),
        ("d=16 h=4/4 s=129", 3, 4, 4, 129, 16, [129, 1, 64], bf16),
        ("d=128 h=4/1 s=1000", 2, 4, 1, 1000, 128, [1000, 333], bf16),
        ("vlen 0 and beyond S d=64", 2, 4, 2, 200, 64, [0, 500], bf16),
        ("ragged S=1000 h=8/2 d=64", 2, 8, 2, 1000, 64, [1000, 611], bf16),
        ("vlen 0, 1 and S+5 h=4/1 d=80 s=300", 3, 4, 1, 300, 80,
         [0, 1, 305], bf16),
        ("every lane inside the first split, zamba2 shape", 8, 32, 32, 2048,
         80, [1, 2, 17, 64, 65, kps // 2, kps - 1, kps], bf16),
        ("tinyllama G=8 h=32/4 d=64 s=2048", 8, 32, 4, 2048, 64,
         [898, 693, 572, 340, 376, 120, 2048, 1], bf16),
        ("zamba2 G=1 h=32/32 d=80 s=2048", 8, 32, 32, 2048, 80,
         [897] * 8, bf16),
    ]
    errs, timed = [], {}
    for label, b, h, kvh, s, d, vlens, dtype in cases:
        q = randn(b, h, d, dtype=dtype)
        k, v = randn(b, kvh, s, d, dtype=dtype), randn(b, kvh, s, d,
                                                         dtype=dtype)
        vlen = torch.tensor(vlens, dtype=torch.int32, device=dev)
        got = decode_attention(q, k, v, vlen)
        want = decode_attention_ref(q.float(), k.float(), v.float(), vlen)
        errs.append(compare(torch, f"decode_attention {label}", got, want,
                            *tol[dtype], rerun=lambda: decode_attention(
                                q, k, v, vlen)))
        for i, n in enumerate(vlens):
            if n == 0 and float(got[i].abs().max()) != 0.0:
                fail("decode_attention: a lane of valid length 0 must "
                     "return zeros")
        timed[label.split()[0]] = (q, k, v, vlen)
    same_twice(torch, "decode_attention zamba2 G=1",
               lambda: (decode_attention(q, k, v, vlen),))
    ms, plain, lib, b_ms, b_by = _decode_times(torch, *timed["tinyllama"])
    print(f"[time] decode_attention at tinyllama's G=8 shape (B=8 H=32 KV=4 "
          f"D=64 S=2048, vlen 120-2048): kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, library {lib:.4f} ms (SDPA, length mask), bound "
          f"{b_ms:.4f} ms ({b_by}), share of bound {b_ms / ms:.3f}",
          flush=True)
    # the record: zamba2's decode shape (last case), every lane at the
    # shared position 896 of the serve run's longest prompt, cache 2048
    ms, plain, lib, b_ms, b_by = _decode_times(torch, q, k, v, vlen)
    kernel_split(torch, lambda: decode_attention(q, k, v, vlen),
                 "decode_attention at zamba2's decode shape")
    print(f"[time] decode_attention at zamba2's decode shape: share of "
          f"bound {b_ms / ms:.3f}, kernel / SDPA {ms / lib:.3f}", flush=True)
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:63",
                max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib,
                shape=f"B=8 H=32 KV=32 D=80 S=2048, vlen 897 every lane, "
                      f"{splits} splits of {kps} keys; library_ms is SDPA "
                      "with a length mask")


# ---------------------------------------------------------------------------
# phase 2, head dim 256: K1, K2 and K4 at gemma3-12b's shapes
# ---------------------------------------------------------------------------

def check_head_dim_256(torch, randn, tol):
    """K1, K2 and K4 at gemma3-12b's head dim 256 (16 query heads over 8
    KV heads), bf16, against their plain versions at phase 2's
    tolerances: K1 with q (8,16,256) over pages (193,128,8,256), a global
    table of ~2000 live tokens a lane and a 9-page ring read with window
    1024 after it has wrapped; K2 at the 2048-token prefill, causal, with
    window 1024 (the local layers) and without (the global ones), by
    relative norm as ``check_fwd`` holds every bf16 case; K4 with q
    (8,16,256) over a (8,8,1024,256) cache, valid length 1024 (the dense
    ring, full).  Each is timed beside its plain version and SDPA on
    contiguous copies, with its bound from what the inputs need.
    Returns their records (named ``*_d256``; their launches are phase
    11's)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_ref,
                                                     fwd_block_k)
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref,
                                                     split_pages)
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(256)
    b, h, kvh, d, pool, page = 8, 16, 8, 256, 192, 128
    records = []

    # -- K1: a global table, and a wrapped ring ---------------------------
    kp, vp = randn(pool + 1, page, kvh, d), randn(pool + 1, page, kvh, d)
    q = randn(b, h, d)
    perm = torch.randperm(pool, generator=g, device=dev).int()
    glob = [2000, 1990, 2048, 1900, 1999, 2010, 1950, 2020]
    table = torch.full((b, 16), -1, dtype=torch.int32, device=dev)
    for i, n in enumerate(glob):
        table[i, :-(-n // page)] = perm[16 * i:16 * i + -(-n // page)]
    vlen = torch.tensor(glob, dtype=torch.int32, device=dev)
    ring_t = perm[:72].view(b, 9).contiguous()
    ring_v = torch.tensor([1500, 2000, 1153, 3000, 1800, 1200, 2500, 1700],
                          dtype=torch.int32, device=dev)
    errs = []
    for label, tb, vl, kw in (("global table ~2000 tokens", table, vlen, {}),
                              ("9-page ring, window 1024, wrapped", ring_t,
                               ring_v, dict(window=1024, ring=True))):
        errs.append(compare(
            torch, f"paged_attention d=256 {label}",
            paged_attention(q, kp, vp, tb, vl, **kw),
            paged_attention_ref(q, kp, vp, tb, vl, **kw), *tol[bf16]))
    pps, splits = split_pages(b, kvh, 16, torch.cuda.get_device_properties(
        0).multi_processor_count)

    def k1_times(tb, vl, window, ring):
        ms = timed_ms(torch, lambda: paged_attention(
            q, kp, vp, tb, vl, window=window, ring=ring))
        plain = timed_ms(torch, lambda: paged_attention_ref(
            q, kp, vp, tb, vl, window=window, ring=ring), iters=5, reps=3)
        # the lanes' live tokens gathered into a contiguous cache, with the
        # same mask
        safe = tb.clamp(min=0).long()
        kc = kp[safe].flatten(1, 2).transpose(1, 2).contiguous()
        vc = vp[safe].flatten(1, 2).transpose(1, 2).contiguous()
        slot = torch.arange(kc.shape[2], device=dev)[None, :]
        last = vl[:, None] - 1
        pos = last - torch.remainder(last - slot, kc.shape[2]) if ring \
            else slot
        mask = (pos >= 0) & (pos <= last) & tb.repeat_interleave(
            page, dim=1).ge(0)
        if window:
            mask &= pos > last - window
        lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask[:, None, None],
            enable_gqa=True))
        attended = int(mask.sum())
        nbytes = (2 * q.numel() * 2 + tb.numel() * 4 + vl.numel() * 4
                  + 2 * attended * kvh * d * 2)
        b_ms, b_by = bound(nbytes, 4 * h * d * attended, H100_BF16_FLOPS)
        return ms, plain, lib, b_ms, b_by

    ms, plain, lib, b_ms, b_by = k1_times(ring_t, ring_v, 1024, True)
    print(f"[time] paged_attention d=256 ring (B=8 H=16 KV=8, 9-page ring, "
          f"window 1024): kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
          f"{lib:.4f} ms (SDPA, gathered, ring mask), bound {b_ms:.4f} ms "
          f"({b_by}), share of bound {b_ms / ms:.3f}", flush=True)
    ms, plain, lib, b_ms, b_by = k1_times(table, vlen, 0, False)
    records.append(dict(
        name="paged_attention_d256", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:111",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        shape=f"gemma3-12b decode: B=8 H=16 KV=8 D=256, global table, vlen "
              f"{glob}, {splits} splits of {pps} page(s); library_ms is "
              "SDPA on the gathered cache"))

    # -- K2: the 2048-token prefill, window 1024 and none -------------------
    errs = []
    for window in (1024, 0):
        q2 = randn(1, 2048, h, d).transpose(1, 2)             # model layout
        k2 = randn(1, 2048, kvh, d).transpose(1, 2)
        v2 = randn(1, 2048, kvh, d).transpose(1, 2)
        errs.append(check_fwd(torch, f"d=256 gemma3 prefill s=2048 window="
                                     f"{window}", q2, k2, v2, dict(
                                         causal=True, window=window,
                                         q_offset=0), tol)[0])
    # the kernel on the model's layout, SDPA on contiguous copies
    qc, kc, vc = q2.contiguous(), k2.contiguous(), v2.contiguous()
    for window in (0, 1024):                   # the record: window 1024
        ms = timed_ms(torch, lambda: flash_attention_fwd(
            q2, k2, v2, causal=True, window=window))
        plain = timed_ms(torch, lambda: flash_attention_fwd_ref(
            q2, k2, v2, causal=True, window=window, operand_dtype=bf16,
            block_k=fwd_block_k(d)), iters=3, reps=3)
        ok = torch.ones(2048, 2048, dtype=torch.bool, device=dev).tril()
        if window:
            ok = ok.triu(-(window - 1))
        lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=ok, enable_gqa=True))
        pairs = int(ok.sum())
        nbytes = 2 * (2 * q2.numel() + k2.numel() + v2.numel()) \
            + 4 * 2048 * h
        b_ms, b_by = bound(nbytes, 4 * h * d * pairs, H100_BF16_FLOPS)
        print(f"[time] flash_attention_fwd d=256 (B=1 H=16 KV=8 S=2048 causal "
              f"window={window}): kernel {ms:.4f} ms, plain {plain:.4f} ms "
              f"(bf16 operands), library {lib:.4f} ms (SDPA), bound "
              f"{b_ms:.4f} ms ({b_by}), share of bound {b_ms / ms:.3f}",
              flush=True)
    records.append(dict(
        name="flash_attention_fwd_d256", route="cuda",
        source="src/repro_torch/csrc/flash_attention_fwd.cu",
        replaces="src/repro/kernels/flash_attention.py:96",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        shape="gemma3-12b prefill: B=1 H=16 KV=8 D=256 S=2048 causal "
              "window=1024 (a local layer); plain_ms is the plain version "
              "with bf16 operands"))
    del q2, k2, v2, qc, kc, vc
    torch.cuda.empty_cache()

    # -- K4: the dense ring, full -------------------------------------------
    q4 = randn(b, h, d)
    k4, v4 = randn(b, kvh, 1024, d), randn(b, kvh, 1024, d)
    vl4 = torch.full((b,), 1024, dtype=torch.int32, device=dev)
    errs = [compare(torch, "decode_attention d=256 gemma3 ring valid 1024",
                    decode_attention(q4, k4, v4, vl4),
                    decode_attention_ref(q4.float(), k4.float(), v4.float(),
                                         vl4), *tol[bf16],
                    rerun=lambda: decode_attention(q4, k4, v4, vl4))]
    ragged = torch.tensor([1024, 1, 0, 500, 1000, 129, 700, 1029],
                          dtype=torch.int32, device=dev)
    errs.append(compare(torch, "decode_attention d=256 lengths 0-1029",
                        decode_attention(q4, k4, v4, ragged),
                        decode_attention_ref(q4.float(), k4.float(),
                                             v4.float(), ragged),
                        rerun=lambda: decode_attention(q4, k4, v4, ragged),
                        *tol[bf16]))
    ms = timed_ms(torch, lambda: decode_attention(q4, k4, v4, vl4))
    plain = timed_ms(torch, lambda: decode_attention_ref(q4, k4, v4, vl4))
    lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
        q4[:, :, None], k4, v4, enable_gqa=True))
    attended = b * 1024
    nbytes = 2 * q4.numel() * 2 + b * 4 + 2 * attended * kvh * d * 2
    b_ms, b_by = bound(nbytes, 4 * h * d * attended, H100_BF16_FLOPS)
    records.append(dict(
        name="decode_attention_d256", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:63",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        shape="gemma3-12b dense decode: B=8 H=16 KV=8 D=256 S=1024 (a "
              "local layer's full ring), valid 1024; library_ms is SDPA"))
    return records


def check_head_dim_128(torch, randn, tol):
    """K1 and K2 at mistral-nemo-12b's head dim 128 (32 query heads over 8
    KV heads), bf16, against their plain versions at phase 2's
    tolerances, as phase 12's prefix-cached serve runs them.  K1 with q
    (8,32,128) over pages (193,128,8,128): 8 lanes of 1600..2012 tokens
    whose tables all start with the SAME 12 physical pages (the cached
    system prompt), and again with a ninth lane of -1.  K2, by relative
    norm as ``check_fwd`` holds every bf16 case, at the three chunk
    shapes of a warm or cold prompt of ~1500 + 512 tokens: a first chunk
    q (1,32,512,128) causal at offset 0; the warm lead chunk q
    (1,32,128,128) over k/v (1,8,1536,128) at ``q_offset=1408``; a suffix
    chunk q (1,32,512,128) over k/v (1,8,2048,128) at ``q_offset=1536``.
    Each is timed beside its plain version and SDPA on contiguous
    copies.  K1's byte bound is stated both ways: over the unique pages
    (each input read once, the record's) and over the pages each lane
    reads.  Returns their records (named ``*_d128``; their launches are
    phase 12's)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_ref,
                                                     fwd_block_k)
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref,
                                                     split_pages)
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(128)
    b, h, kvh, d, pool, page, shared = 8, 32, 8, 128, 192, 128, 12
    records = []

    # -- K1: every lane's table leads with the same 12 physical pages ------
    kp, vp = randn(pool + 1, page, kvh, d), randn(pool + 1, page, kvh, d)
    q = randn(b + 1, h, d)
    perm = torch.randperm(pool, generator=g, device=dev).int()
    lens = [2012, 1600, 1890, 1700, 1999, 1650, 1801, 1950]
    table = torch.full((b + 1, 16), -1, dtype=torch.int32, device=dev)
    used = shared
    for i, n in enumerate(lens):
        n_pg = -(-n // page)
        table[i, :shared] = perm[:shared]
        table[i, shared:n_pg] = perm[used:used + n_pg - shared]
        used += n_pg - shared
    vlen = torch.tensor(lens + [1], dtype=torch.int32, device=dev)
    errs = []
    for label, nb in (("8 lanes sharing 12 leading pages", b),
                      ("the same + a lane of -1", b + 1)):
        got = paged_attention(q[:nb], kp, vp, table[:nb], vlen[:nb])
        errs.append(compare(
            torch, f"paged_attention d=128 {label}", got,
            paged_attention_ref(q[:nb], kp, vp, table[:nb], vlen[:nb]),
            *tol[bf16]))
        if nb > b and float(got[-1].abs().max()) != 0.0:
            fail("paged_attention d=128: an all -1 lane must return zeros")
    q, table, vlen = q[:b], table[:b].contiguous(), vlen[:b].contiguous()
    pps, splits = split_pages(b, kvh, 16, torch.cuda.get_device_properties(
        0).multi_processor_count)
    ms = timed_ms(torch, lambda: paged_attention(q, kp, vp, table, vlen))
    plain = timed_ms(torch, lambda: paged_attention_ref(q, kp, vp, table,
                                                        vlen))
    safe = table.clamp(min=0).long()
    kc = kp[safe].flatten(1, 2).transpose(1, 2).contiguous()
    vc = vp[safe].flatten(1, 2).transpose(1, 2).contiguous()
    slot = torch.arange(kc.shape[2], device=dev)[None, :]
    mask = (slot < vlen[:, None]) & table.repeat_interleave(page, dim=1).ge(0)
    lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=mask[:, None, None],
        enable_gqa=True))
    attended = int(mask.sum())
    # each input read once: the shared pages' tokens count once, whatever
    # number of lanes attend to them
    unique = attended - (b - 1) * shared * page
    small = 2 * q.numel() * 2 + table.numel() * 4 + vlen.numel() * 4
    b_ms, b_by = bound(small + 2 * unique * kvh * d * 2,
                       4 * h * d * attended, H100_BF16_FLOPS)
    lane_ms, lane_by = bound(small + 2 * attended * kvh * d * 2,
                             4 * h * d * attended, H100_BF16_FLOPS)
    print(f"[time] paged_attention d=128 (B=8 H=32 KV=8, {attended} tokens "
          f"attended, the first {shared} pages of every lane shared): "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms "
          f"(SDPA, gathered); bound over the unique pages {b_ms:.4f} ms "
          f"({b_by}, share {b_ms / ms:.3f}), over the pages each lane "
          f"reads {lane_ms:.4f} ms ({lane_by}, share {lane_ms / ms:.3f}); "
          f"{splits} splits of {pps} page(s)", flush=True)
    records.append(dict(
        name="paged_attention_d128", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:111",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        shape=f"mistral-nemo-12b decode: B=8 H=32 KV=8 D=128, vlen {lens}, "
              f"12 shared leading pages; bound_ms over the unique pages "
              f"(over the pages each lane reads: {lane_ms:.4f} ms); "
              "library_ms is SDPA on the gathered cache"))
    del kp, vp, kc, vc
    torch.cuda.empty_cache()

    # -- K2: the three chunk shapes of a ~2000-token prompt -----------------
    errs = []
    for label, sq, sk, off in (("first chunk s=512", 512, 512, 0),
                               ("warm lead chunk sq=128 sk=1536 "
                                "q_offset=1408", 128, 1536, 1408),
                               ("suffix chunk sq=512 sk=2048 "
                                "q_offset=1536", 512, 2048, 1536)):
        q2 = randn(1, sq, h, d).transpose(1, 2)              # model layout
        k2 = randn(1, sk, kvh, d).transpose(1, 2)
        v2 = randn(1, sk, kvh, d).transpose(1, 2)
        kw = dict(causal=True, window=0, q_offset=off)
        errs.append(check_fwd(torch, f"d=128 mistral {label}", q2, k2, v2,
                              kw, tol)[0])
        ms = timed_ms(torch, lambda: flash_attention_fwd(q2, k2, v2, **kw))
        plain = timed_ms(torch, lambda: flash_attention_fwd_ref(
            q2, k2, v2, operand_dtype=bf16, block_k=fwd_block_k(d), **kw))
        qc, kc, vc = q2.contiguous(), k2.contiguous(), v2.contiguous()
        ok = (torch.arange(sk, device=dev)[None, :]
              <= off + torch.arange(sq, device=dev)[:, None])
        lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=ok, enable_gqa=True))
        pairs = int(ok.sum())
        nbytes = 2 * (2 * q2.numel() + k2.numel() + v2.numel()) + 4 * sq * h
        b_ms, b_by = bound(nbytes, 4 * h * d * pairs, H100_BF16_FLOPS)
        print(f"[time] flash_attention_fwd d=128 (B=1 H=32 KV=8 {label}): "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms (bf16 operands), "
              f"library {lib:.4f} ms (SDPA), bound {b_ms:.4f} ms ({b_by}), "
              f"share of bound {b_ms / ms:.3f}", flush=True)
        del q2, k2, v2, qc, kc, vc
        torch.cuda.empty_cache()
    records.append(dict(
        name="flash_attention_fwd_d128", route="cuda",
        source="src/repro_torch/csrc/flash_attention_fwd.cu",
        replaces="src/repro/kernels/flash_attention.py:96",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
        shape="mistral-nemo-12b suffix chunk: B=1 H=32 KV=8 D=128 Sq=512 "
              "Sk=2048 q_offset=1536 causal; plain_ms is the plain version "
              "with bf16 operands"))
    return records


# ---------------------------------------------------------------------------
# phase 2, the families of phase 16: K2 and K4 at phi-3-vision's head dim
# 96, at whisper-base's encoder and cross shapes, K4 at qwen2-moe's
# ---------------------------------------------------------------------------

# whisper-base in phase 16: lanes and prompt tokens of its one prefill
# (phase 2 holds K2 and K4 at the shapes these give them)
WHISPER_LANES, WHISPER_PROMPT = 4, 4


def check_families_kernels(torch, randn, tol):
    """K2 and K4 at the shapes phase 16 gives them, bf16, against their
    plain versions at phase 2's tolerances (K2 by relative norm, as
    ``check_fwd`` holds every bf16 case; K4 elementwise on fp32 copies),
    two launches bit-equal, each timed beside its plain version and SDPA
    with its bound: K2 at phi-3-vision-4.2b's prefill, q/k/v
    (1,32,1024,96) causal, at whisper-base's encoder, (4,8,1500,64)
    non-causal, and its cross attention, q (4,8,4,64) over k/v
    (4,8,1500,64) non-causal, and (no record) at one lane's encoder,
    (1,8,1500,64), and a 448-token prompt's cross attention, q
    (1,8,448,64) over (1,8,1500,64); K4 at phi-3's decode, q (8,32,96)
    over (8,32,2048,96) (lanes of 1..2048 keys), at whisper's cross
    decode, q (4,8,64) over all 1500 frames of (4,8,1500,64), and at
    qwen2-moe's, q (8,16,128) over (8,16,2048,128), G = 1.  Returns the
    records ``*_d96`` and ``*_whisper_*`` (their launches are phase
    16's)."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    records = []

    fwd_cases = [
        ("flash_attention_fwd_d96", "phi-3-vision prefill d=96 h=32/32 "
         "s=1024 causal", 1, 32, 32, 1024, 1024, 96, True),
        ("flash_attention_fwd_whisper_enc", "whisper encoder d=64 h=8/8 "
         "s=1500 non-causal", WHISPER_LANES, 8, 8, 1500, 1500, 64, False),
        ("flash_attention_fwd_whisper_cross", f"whisper cross d=64 h=8/8 "
         f"sq={WHISPER_PROMPT} sk=1500 non-causal", WHISPER_LANES, 8, 8,
         WHISPER_PROMPT, 1500, 64, False),
        (None, "whisper encoder d=64 h=8/8 s=1500 non-causal", 1, 8, 8,
         1500, 1500, 64, False),
        (None, "whisper cross d=64 h=8/8 sq=448 sk=1500 non-causal", 1, 8,
         8, 448, 1500, 64, False),
    ]
    for rec, label, b, h, kvh, sq, sk, d, causal in fwd_cases:
        q = randn(b, sq, h, d).transpose(1, 2)               # model layout
        k = randn(b, sk, kvh, d).transpose(1, 2)
        v = randn(b, sk, kvh, d).transpose(1, 2)
        kw = dict(causal=causal, window=0, q_offset=0)
        err = check_fwd(torch, label, q, k, v, kw, tol)[0]
        same_twice(torch, f"flash_attention_fwd {label}",
                   lambda: flash_attention_fwd(q, k, v, causal=causal))
        ms, plain, lib, b_ms, b_by = _fwd_times(torch, q, k, v, causal)
        print(f"[time] flash_attention_fwd {label} (B={b}): kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms (bf16 operands), library "
              f"{lib:.4f} ms (SDPA), bound {b_ms:.4f} ms ({b_by}), share of "
              f"bound {b_ms / ms:.3f}", flush=True)
        if rec is not None:
            records.append(dict(
                name=rec, route="cuda",
                source="src/repro_torch/csrc/flash_attention_fwd.cu",
                replaces="src/repro/kernels/flash_attention.py:96",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib,
                shape=f"{label} (B={b} H={h} KV={kvh} D={d} Sq={sq} "
                      f"Sk={sk}); plain_ms is the plain version with bf16 "
                      "operands"))
        del q, k, v
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(96)
    phi_lens = torch.randint(1, 2049, (8,), generator=gen, device=dev)
    phi_lens[0], phi_lens[1] = 1, 2048
    dec_cases = [
        ("decode_attention_d96", "phi-3-vision decode d=96 h=32/32 s=2048",
         8, 32, 32, 2048, 96, phi_lens.int()),
        ("decode_attention_whisper_cross", "whisper cross decode d=64 h=8/8 "
         "over 1500 frames", WHISPER_LANES, 8, 8, 1500, 64,
         torch.full((WHISPER_LANES,), 1500, dtype=torch.int32, device=dev)),
        (None, "qwen2-moe decode d=128 h=16/16 s=2048", 8, 16, 16, 2048, 128,
         torch.full((8,), 1055, dtype=torch.int32, device=dev)),
    ]
    for rec, label, b, h, kvh, s, d, vlen in dec_cases:
        q = randn(b, h, d)
        k, v = randn(b, kvh, s, d), randn(b, kvh, s, d)
        err = compare(torch, f"decode_attention {label}",
                      decode_attention(q, k, v, vlen),
                      decode_attention_ref(q.float(), k.float(), v.float(),
                                           vlen), *tol[bf16],
                      rerun=lambda: decode_attention(q, k, v, vlen))
        same_twice(torch, f"decode_attention {label}",
                   lambda: (decode_attention(q, k, v, vlen),))
        ms, plain, lib, b_ms, b_by = _decode_times(torch, q, k, v, vlen)
        print(f"[time] decode_attention {label} (vlen {vlen.tolist()}): "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{lib:.4f} ms (SDPA), bound {b_ms:.4f} ms "
              f"({b_by}), share of bound {b_ms / ms:.3f}", flush=True)
        if rec is not None:
            records.append(dict(
                name=rec, route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:63",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib,
                shape=f"{label}: B={b} H={h} KV={kvh} D={d} S={s}, vlen "
                      f"{vlen.tolist()}; library_ms is SDPA, with a length "
                      "mask where a lane attends to fewer than S keys"))
        del q, k, v
        torch.cuda.empty_cache()
    return records


def _ssd_inputs(torch, randn, b, h, s, p, n, dtype, decay=None, pad=0):
    """The model's layouts: x (B, S, H, P) and B, C slices of one (B, S,
    H*P + 2N + pad) activation (``pad`` elements at the end of each row
    move the rows off 16-byte alignment), dt and a (B, S, H); returned as
    the kernel's (B, H, S, .) views.  a = -exp(noise) dt, or about
    -``decay`` per token."""
    f32 = torch.float32
    xbc = randn(b, s, h * p + 2 * n + pad, dtype=dtype, scale=0.5)
    x = xbc[..., :h * p].unflatten(-1, (h, p)).transpose(1, 2)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:h * p + 2 * n]
    dt = torch.nn.functional.softplus(randn(b, s, h, dtype=f32))
    if decay is None:
        a = -torch.exp(randn(h, dtype=f32, scale=0.5)) * dt
    else:
        a = -decay * torch.exp(randn(b, s, h, dtype=f32, scale=0.1))
    return x, dt.transpose(1, 2), a.transpose(1, 2), bm, cm


def _scan_cases(dim_names):
    """The bf16 cases both scans add to their first four: the lengths
    around the kernels' chunk of 64 and 1000 at the full-width head dims,
    two batch rows at the reduced models' dims, a decay of about -4 per
    token (a chunk's log-decay passes -30 inside one sub-chunk of 16), and
    rows 4 and 2 bytes off 16-byte alignment.  Each case: (label, b, h,
    s, dims, decay, pad)."""
    cases = [(f"s={s} h=2 {dim_names} 64", 1, 2, s, 64, None, 0)
             for s in (1, 15, 16, 17, 63, 64, 65, 1000)]
    cases += [
        (f"b=2 h=4 s=130 {dim_names} 8/16 (reduced)", 2, 4, 130, None, None,
         0),
        (f"strong decay ~-4/token h=2 s=200 {dim_names} 64", 1, 2, 200, 64,
         4.0, 0),
        (f"strong decay ~-4/token b=2 h=2 s=1000 {dim_names} 64", 2, 2, 1000,
         64, 4.0, 0),
        (f"rows 4-byte aligned h=2 s=100 {dim_names} 64", 1, 2, 100, 64, None,
         2),
        (f"rows 2-byte aligned h=2 s=100 {dim_names} 64", 1, 2, 100, 64, None,
         1),
    ]
    return cases


def kernel_split(torch, fn, what, calls=10):
    """Device time per call of each CUDA kernel that ``fn`` launches,
    from ``torch.profiler`` over ``calls`` calls (printed only)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            print(f"[time] {what}: {us / 1e3 / calls:.4f} ms a call in "
                  f"{short_name(e.key)[:80]}", flush=True)


def same_twice(torch, name, fn):
    """Two launches on the same inputs must give bit-equal results."""
    first, second = fn(), fn()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"[kernel] {name}, launched twice: bit-equal: {same}", flush=True)
    if not same:
        fail(f"{name}: two launches on the same inputs differ")


def check_ssd(torch, randn):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("small fp32 h=2 s=64 p=8 n=4", 1, 2, 64, 8, 4, f32, None, 0),
             ("ragged b=2 h=3 s=77 p=16 n=8", 2, 3, 77, 16, 8, bf16, None, 0),
             ("p=64 n=64 h=4 s=200", 1, 4, 200, 64, 64, bf16, None, 0),
             ("p=24 n=128 h=2 s=33", 1, 2, 33, 24, 128, f32, None, 0)]
    cases += [(label, b, h, s, d or 8, d or 8, bf16, decay, pad)
              for label, b, h, s, d, decay, pad in _scan_cases("p/n")]
    errs = []
    for label, b, h, s, p, n, dtype, decay, pad in cases:
        ins = _ssd_inputs(torch, randn, b, h, s, p, n, dtype, decay, pad)
        (y, st), (y_r, st_r) = ssd_scan(*ins), ssd_scan_ref(*ins)
        errs.append(compare(torch, f"ssd_scan y {label}", y, y_r, 1e-4, 1e-4,
                            rerun=lambda: ssd_scan(*ins)[0]))
        compare(torch, f"ssd_scan state {label}", st, st_r, 1e-4, 1e-4,
                rerun=lambda: ssd_scan(*ins)[1])
    # zamba2's prefill shape: 80 heads of P 64, N 64, a ragged 1000 tokens
    b, h, s, p, n = 1, 80, 1000, 64, 64
    ins = _ssd_inputs(torch, randn, b, h, s, p, n, bf16)
    (y, st), (y_r, st_r) = ssd_scan(*ins), ssd_scan_ref(*ins)
    errs.append(rel_norm(torch, "ssd_scan y zamba2 h=80 s=1000 p=64 n=64", y,
                         y_r, SCAN_REL_NORM))
    rel_norm(torch, "ssd_scan state zamba2", st, st_r, SCAN_REL_NORM)
    del y_r, st_r
    same_twice(torch, "ssd_scan at zamba2's shape", lambda: ssd_scan(*ins))
    ms = timed_ms(torch, lambda: ssd_scan(*ins))
    plain = timed_ms(torch, lambda: ssd_scan_ref(*ins), iters=3, reps=3)
    x, dt, a, bm, cm = ins
    ins32 = (x.float(), dt, a, bm.float(), cm.float())
    fp32 = timed_ms(torch, lambda: ssd_scan(*ins32), iters=3, reps=3)
    kernel_split(torch, lambda: ssd_scan(*ins), "ssd_scan at zamba2's shape")
    nbytes = (b * h * s * p * 2 + 2 * b * h * s * 4 + 2 * b * s * n * 2
              + b * h * s * p * 4 + b * h * p * n * 4)
    # per token and state element: h*exp(a) + (x dt) B (3), y += C h (2);
    # bf16 inputs: the bf16 matrix peak, at which a chunked form runs them
    b_ms, b_by = bound(nbytes, 5 * b * h * s * p * n, H100_BF16_FLOPS)
    print(f"[time] ssd_scan at zamba2's shape: kernel {ms:.4f} ms (bf16, "
          f"chunked, tensor cores), fp32 route {fp32:.4f} ms (token by "
          f"token), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:69",
                max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"x (B={b}, H={h}, S={s}, P={p}) bf16 strided, N={n}")


def _wkv_inputs(torch, randn, b, h, s, hd, dtype, decay=1.0, pad=0):
    """The model's layout (B, S, H, hd), returned as (B, H, S, hd) views;
    r, k and v rows of H*hd + ``pad`` elements (a pad moves them off
    16-byte alignment); logw = -exp(noise - shift) about -``decay`` per
    token."""
    r, k, v = (randn(b, s, h * hd + pad, dtype=dtype, scale=0.5)[..., :h * hd]
               .unflatten(-1, (h, hd)).transpose(1, 2) for _ in range(3))
    logw = -torch.exp(randn(b, s, h, hd, dtype=torch.float32, scale=0.5)
                      + math.log(decay)).transpose(1, 2)
    u = randn(h, hd, dtype=dtype, scale=0.3)
    return r, k, v, logw, u


def check_wkv(torch, randn):
    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv, rwkv6_wkv_ref
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("small fp32 h=2 s=64 hd=8", 1, 2, 64, 8, f32, 1.0, 0),
             ("ragged b=2 h=3 s=77 hd=16", 2, 3, 77, 16, bf16, 1.0, 0),
             ("hd=64 h=4 s=200", 1, 4, 200, 64, bf16, 1.0, 0),
             ("hd=32 h=2 s=33 fp32", 1, 2, 33, 32, f32, 1.0, 0)]
    cases += [(label, b, h, s, d or 16, bf16, decay or 1.0, pad)
              for label, b, h, s, d, decay, pad in _scan_cases("hd")]
    errs = []
    for label, b, h, s, hd, dtype, decay, pad in cases:
        ins = _wkv_inputs(torch, randn, b, h, s, hd, dtype, decay, pad)
        (o, st), (o_r, st_r) = rwkv6_wkv(*ins), rwkv6_wkv_ref(*ins)
        errs.append(compare(torch, f"rwkv6_wkv o {label}", o, o_r, 1e-4,
                            1e-4, rerun=lambda: rwkv6_wkv(*ins)[0]))
        compare(torch, f"rwkv6_wkv state {label}", st, st_r, 1e-4, 1e-4,
                rerun=lambda: rwkv6_wkv(*ins)[1])
    # rwkv6-7b's prefill shape: 64 heads of 64, a ragged 1000 tokens
    b, h, s, hd = 1, 64, 1000, 64
    ins = _wkv_inputs(torch, randn, b, h, s, hd, bf16)
    (o, st), (o_r, st_r) = rwkv6_wkv(*ins), rwkv6_wkv_ref(*ins)
    errs.append(rel_norm(torch, "rwkv6_wkv o rwkv6 h=64 s=1000 hd=64", o, o_r,
                         SCAN_REL_NORM))
    rel_norm(torch, "rwkv6_wkv state rwkv6", st, st_r, SCAN_REL_NORM)
    del o_r, st_r
    same_twice(torch, "rwkv6_wkv at rwkv6-7b's shape",
               lambda: rwkv6_wkv(*ins))
    ms = timed_ms(torch, lambda: rwkv6_wkv(*ins))
    plain = timed_ms(torch, lambda: rwkv6_wkv_ref(*ins), iters=3, reps=3)
    r, k, v, logw, u = ins
    ins32 = (r.float(), k.float(), v.float(), logw, u)
    fp32 = timed_ms(torch, lambda: rwkv6_wkv(*ins32), iters=3, reps=3)
    kernel_split(torch, lambda: rwkv6_wkv(*ins),
                 "rwkv6_wkv at rwkv6-7b's shape")
    nbytes = (3 * b * h * s * hd * 2 + 2 * b * h * s * hd * 4 + h * hd * 2
              + b * h * hd * hd * 4)
    # per token and state element: r S (2), S w + k v (3); the bonus
    # (r . u k) v is per channel, not per state element.  bf16 inputs: the
    # bf16 matrix peak, at which a chunked form runs these products
    b_ms, b_by = bound(nbytes, 5 * b * h * s * hd * hd, H100_BF16_FLOPS)
    print(f"[time] rwkv6_wkv at rwkv6-7b's shape: kernel {ms:.4f} ms (bf16, "
          f"chunked, tensor cores), fp32 route {fp32:.4f} ms (token by "
          f"token), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    return dict(name="rwkv6_wkv", route="cuda",
                source="src/repro_torch/csrc/rwkv6_scan.cu",
                replaces="src/repro/kernels/rwkv6_scan.py:73",
                max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"r,k,v (B={b}, H={h}, S={s}, hd={hd}) bf16 strided, "
                      "logw fp32")


# bf16 backward: the tensor-core kernels round p and ds to bf16 where they
# become operands of the second products.  Against the plain version that
# rounds at the same places they differ only by fp32 summation order and
# the rare bf16 rounding that flips with it; against the fp32 plain
# version by the rounding itself (relative norm 2.5e-3 to 2.7e-3 on the
# CPU at five shapes), so that limit is about 4x what was measured.
BWD_KERNEL_REL_NORM = 1e-3
BWD_FP32_REL_NORM = 1e-2


def check_bf16_grad(torch, name, got, want_bf16, want_fp32, tol):
    """One gradient of a bf16 backward kernel: gated by relative norm
    against both plain versions; the worst elementwise err/tol against the
    bf16-operand one is printed for information.  Returns the max abs
    error against that one and the relative norm against the fp32 one."""
    worst = rel_norm(torch, f"{name} vs plain (bf16 operands)", got,
                     want_bf16, BWD_KERNEL_REL_NORM)
    compare(torch, f"{name} vs plain (bf16 operands), information only",
            got, want_bf16, *tol, gate=False)
    rel_norm(torch, f"{name} vs plain (fp32)", got, want_fp32,
             BWD_FP32_REL_NORM)
    err = float((got.float() - want_fp32.float()).norm()
                / want_fp32.float().norm())
    return worst, err


def sdpa_grads(torch, q, k, v, do, causal):
    """SDPA's own backward on KV heads expanded to the query heads, dK and
    dV summed back over each KV head's G query heads: the yardstick."""
    import torch.nn.functional as F
    kvh, g = k.shape[1], q.shape[1] // k.shape[1]
    ins = [t.detach().requires_grad_(True) for t in
           (q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1))]
    out = F.scaled_dot_product_attention(*ins, is_causal=causal)
    dq, dk, dv = torch.autograd.grad(out, ins, do)
    return dq, *(t.float().unflatten(1, (kvh, g)).sum(2) for t in (dk, dv))


def tensor_core_sass(libs):
    """HMMA/HGMMA instructions in the SASS of each bf16 kernel (``_tc`` in
    its name) of the built libraries ``libs`` ({source: number of bf16
    kernels}), counted by ``cuobjdump``; fails on a kernel with none or on
    another number of them.  Skipped, with a note, where ``cuobjdump`` is
    not found."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("[sass] cuobjdump not found: tensor-core instructions not "
              "counted", flush=True)
        return
    for lib, want in libs.items():
        out = subprocess.run([tool, "-sass", str(_build.lib_path(lib))],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            fail(f"cuobjdump: {out.stderr.strip()[:500]}")
        counts, fn = {}, None
        for line in out.stdout.splitlines():
            if "Function : " in line:
                fn = line.split("Function : ", 1)[1].strip()
                counts[fn] = 0
            elif fn is not None and ("HMMA" in line or "HGMMA" in line):
                counts[fn] += 1
        for fn, n in sorted(counts.items()):
            route = "bf16" if "_tc" in fn else "fp32"
            print(f"[sass] {lib} {route} {fn}: {n} HMMA/HGMMA", flush=True)
        tc = {fn: n for fn, n in counts.items() if "_tc" in fn}
        if len(tc) != want or min(tc.values()) == 0:
            fail(f"{lib}: {len(tc)} bf16 kernels in the SASS, expected "
                 f"{want} (one a head dim and pass or launch), each with "
                 "HMMA")


def check_backward(torch, randn, tol):
    """K5a (dQ) and K5b (dK/dV) against their plain versions on the same
    inputs.  fp32 cases: both compute in fp32 from the same saved lse and
    round once, so the tolerance is the fp32 one.  bf16 cases: the
    tensor-core kernels round p and ds to bf16 as operands, so each of dQ,
    dK and dV is held by relative norm against the plain version that
    rounds at the same places (``BWD_KERNEL_REL_NORM``) and against the
    fp32 plain version (``BWD_FP32_REL_NORM``).  The K2 output they start
    from is first held against the plain forward on fp32 copies, as in
    :func:`check_kernels`, at every case's shape (the training shape
    included).  At the training shape SDPA's own backward is held against
    the same fp32 plain version for comparison, the bf16 kernels run twice
    for bit-equal results, and both kernels are timed causal and not.
    Returns the K5 records and the K2 errors."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        BWD_HEAD_DIMS, HEAD_DIMS, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_dkv_ref,
        flash_attention_dq_ref, flash_attention_fwd, flash_attention_fwd_ref)
    bf16, f32 = torch.bfloat16, torch.float32
    # the forward at each of its head dims, the backward's dQ and dK/dV at
    # each of theirs
    tensor_core_sass({"flash_attention_fwd": len(HEAD_DIMS),
                      "flash_attention_bwd": 2 * len(BWD_HEAD_DIMS)})
    cases = [
        ("small causal ragged GQA b=2 h=4/2 s=200 d=64", 2, 4, 2, 200, 200,
         64, True, 0, 0, bf16),
        ("windowed=64 fp32 h=4/1 s=256 d=32", 1, 4, 1, 256, 256, 32, True, 64,
         0, f32),
        ("non-causal ragged h=2/2 s=130 d=16", 1, 2, 2, 130, 130, 16, False,
         0, 0, bf16),
        ("windowed=100 ragged h=8/2 s=333 d=64", 1, 8, 2, 333, 333, 64, True,
         100, 0, bf16),
        ("d=128 q_offset=64 h=4/2 sq=128 sk=192", 1, 4, 2, 128, 192, 128,
         True, 0, 64, bf16),
        # zamba2-2.7b's head dim: 5 k-steps of 16, 32-row loop tiles
        ("d=80 fp32 windowed=50 ragged h=4/2 s=150", 1, 4, 2, 150, 150, 80,
         True, 50, 0, f32),
        ("d=80 causal ragged b=2 h=4/4 s=200", 2, 4, 4, 200, 200, 80, True,
         0, 0, bf16),
        # q and dO rows 4 elements apart from 16-byte alignment: the
        # wrappers copy them for the kernels' cp.async
        ("d=32 non-causal GQA sq=100 sk=300 h=4/1 unaligned q/dO", 1, 4, 1,
         100, 300, 32, False, 0, 0, bf16),
        # phi-3-vision-4.2b's head dim, and Sq != Sk without a mask over a
        # ragged key tail (whisper's cross attention: more rows than keys)
        ("d=96 causal ragged b=2 h=4/4 s=200", 2, 4, 4, 200, 200, 96, True,
         0, 0, bf16),
        ("d=96 fp32 non-causal ragged h=2/2 s=130", 1, 2, 2, 130, 130, 96,
         False, 0, 0, f32),
        ("d=64 non-causal sq=333 sk=150 b=2 h=4/4", 2, 4, 4, 333, 150, 64,
         False, 0, 0, bf16),
        ("d=96 non-causal sq=100 sk=300 h=4/2", 1, 4, 2, 100, 300, 96,
         False, 0, 0, bf16),
        # gemma3-12b's head dim: dK/dV split over two warps a key slice,
        # and the fp32 route staged 128 columns at a time
        ("d=256 causal GQA ragged h=16/8 s=200", 1, 16, 8, 200, 200, 256,
         True, 0, 0, bf16),
        ("d=256 windowed=100 ragged h=4/2 s=333", 1, 4, 2, 333, 333, 256,
         True, 100, 0, bf16),
        ("d=256 fp32 windowed=100 ragged h=4/2 s=200", 1, 4, 2, 200, 200,
         256, True, 100, 0, f32),
        ("d=256 non-causal sq=100 sk=300 h=4/2", 1, 4, 2, 100, 300, 256,
         False, 0, 0, bf16),
        ("training shape b=2 h=32/4 s=4096 d=64", 2, 32, 4, 4096, 4096, 64,
         True, 0, 0, bf16),
    ]
    errs = {"dq": [], "dkv": [], "fwd": []}
    for (label, b, h, kvh, sq, sk, d, causal, window, off, dtype) in cases:
        kw = dict(causal=causal, window=window, q_offset=off)
        pad = 4 if "unaligned" in label else 0

        def query_rows():  # model layout, rows h*d + pad elements apart
            return (randn(b, sq, h * d + pad, dtype=dtype)[..., :h * d]
                    .unflatten(-1, (h, d)).transpose(1, 2))

        q = query_rows()
        k = randn(b, sk, kvh, d, dtype=dtype).transpose(1, 2)
        v = randn(b, sk, kvh, d, dtype=dtype).transpose(1, 2)
        do = query_rows()
        err, o, lse = check_fwd(torch, label, q, k, v, kw, tol)
        errs["fwd"].append(err)
        training = label.startswith("training")
        lib = sdpa_grads(torch, q, k, v, do, causal) if training else None
        dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do, **kw)
        torch.cuda.synchronize()
        dq_r, delta_r = flash_attention_dq_ref(q, k, v, o, lse, do, **kw)
        compare(torch, f"flash_attention_bwd delta {label}", delta, delta_r,
                1e-4, 1e-5, rerun=lambda: flash_attention_bwd_dq(
                    q, k, v, o, lse, do, **kw)[1])
        name = f"flash_attention_bwd {{}} {label}"
        if dtype == f32:
            errs["dq"].append(compare(
                torch, name.format("dq"), dq, dq_r, *tol[dtype],
                rerun=lambda: flash_attention_bwd_dq(q, k, v, o, lse, do,
                                                     **kw)[0]))
            dk_r, dv_r = flash_attention_dkv_ref(q, k, v, lse, delta_r, do,
                                                 **kw)

            def dkv(i):
                return flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                               **kw)[i]

            errs["dkv"].append(max(
                compare(torch, name.format("dk"), dk, dk_r, *tol[dtype],
                        rerun=lambda: dkv(0)),
                compare(torch, name.format("dv"), dv, dv_r, *tol[dtype],
                        rerun=lambda: dkv(1))))
            del dq_r, dk_r, dv_r, delta_r
            continue
        # bf16: one plain version at a time, the training shape's are large
        want_b, _ = flash_attention_dq_ref(q, k, v, o, lse, do,
                                           operand_dtype=bf16, **kw)
        worst, err = check_bf16_grad(torch, name.format("dq"), dq, want_b,
                                     dq_r, tol[dtype])
        errs["dq"].append(worst)
        kernel_err = {"dq": err}
        del dq_r, want_b
        torch.cuda.empty_cache()
        got = {"dk": dk, "dv": dv}
        want_f = dict(zip(("dk", "dv"), flash_attention_dkv_ref(
            q, k, v, lse, delta_r, do, **kw)))
        want_b = dict(zip(("dk", "dv"), flash_attention_dkv_ref(
            q, k, v, lse, delta_r, do, operand_dtype=bf16, **kw)))
        for n in ("dk", "dv"):
            worst, kernel_err[n] = check_bf16_grad(
                torch, name.format(n), got[n], want_b[n], want_f[n],
                tol[dtype])
            errs["dkv"].append(worst)
        if training:
            want_f["dq"], _ = flash_attention_dq_ref(q, k, v, o, lse, do,
                                                     **kw)
            for n, t in zip(("dq", "dk", "dv"), lib):
                e = float((t.float() - want_f[n].float()).norm()
                          / want_f[n].float().norm())
                print(f"[kernel] {n} relative norm to the fp32 plain version "
                      f"at the training shape: kernel {kernel_err[n]:.3e}, "
                      f"SDPA's backward {e:.3e}", flush=True)
        del want_f, want_b, delta_r, lib
        torch.cuda.empty_cache()
    # the training shape (last case): the bf16 kernels are deterministic
    kw = dict(causal=True)
    dq2, delta2 = flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, lse, delta2, do, **kw)
    same = all(torch.equal(a, w) for a, w in
               ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
    print(f"[kernel] flash_attention_bwd at the training shape, launched "
          f"twice: dq, delta, dk, dv bit-equal: {same}", flush=True)
    if not same:
        fail("flash_attention_bwd: two launches on the same inputs differ")
    del dq2, delta2, dk2, dv2
    o2, lse2 = flash_attention_fwd(q, k, v, **kw)
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    print(f"[kernel] flash_attention_fwd at the training shape, launched "
          f"twice: o, lse bit-equal: {same}", flush=True)
    if not same:
        fail("flash_attention_fwd: two launches on the same inputs differ")
    del o2, lse2
    # timed there; the plain versions and the library call materialize
    # (B, H, S, S) fp32 scores, so fewer calls
    few = dict(iters=3, reps=3)
    ms_dq = timed_ms(torch, lambda: flash_attention_bwd_dq(q, k, v, o, lse,
                                                           do, **kw))
    ms_dkv = timed_ms(torch, lambda: flash_attention_bwd_dkv(
        q, k, v, lse, delta, do, **kw))
    ms_fwd = timed_ms(torch, lambda: flash_attention_fwd(q, k, v, **kw))
    ms_fwd_n = timed_ms(torch, lambda: flash_attention_fwd(q, k, v,
                                                           causal=False))
    plain_fwd = timed_ms(torch, lambda: flash_attention_fwd_ref(
        q, k, v, operand_dtype=bf16, **kw), **few)
    plain_dq = timed_ms(torch, lambda: flash_attention_dq_ref(
        q, k, v, o, lse, do, operand_dtype=bf16, **kw), **few)
    plain_dkv = timed_ms(torch, lambda: flash_attention_dkv_ref(
        q, k, v, lse, delta, do, operand_dtype=bf16, **kw), **few)
    g = h // kvh
    qe, ke, ve = (t.detach().requires_grad_(True) for t in
                  (q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)))

    def lib_fwd(causal=True):
        with torch.no_grad():
            F.scaled_dot_product_attention(qe, ke, ve, is_causal=causal)

    def lib_fwd_bwd(causal=True):
        out = F.scaled_dot_product_attention(qe, ke, ve, is_causal=causal)
        torch.autograd.grad(out, (qe, ke, ve), do)

    lib_f = timed_ms(torch, lib_fwd, **few)
    lib_f_n = timed_ms(torch, lambda: lib_fwd(False), **few)
    lib = timed_ms(torch, lib_fwd_bwd, **few) - lib_f
    # non-causal at the same shape: twice the work of causal, so a
    # balanced causal grid takes about half the time
    o_n, lse_n = flash_attention_fwd(q, k, v, causal=False)
    _, delta_n = flash_attention_bwd_dq(q, k, v, o_n, lse_n, do, causal=False)
    ms_dq_n = timed_ms(torch, lambda: flash_attention_bwd_dq(
        q, k, v, o_n, lse_n, do, causal=False))
    ms_dkv_n = timed_ms(torch, lambda: flash_attention_bwd_dkv(
        q, k, v, lse_n, delta_n, do, causal=False))
    lib_n = timed_ms(torch, lambda: lib_fwd_bwd(False), **few) - lib_f_n
    print(f"[time] flash attention backward at the training shape, causal / "
          f"non-causal: dQ {ms_dq:.4f} / {ms_dq_n:.4f} ms (ratio "
          f"{ms_dq / ms_dq_n:.4f}), dK/dV {ms_dkv:.4f} / {ms_dkv_n:.4f} ms "
          f"(ratio {ms_dkv / ms_dkv_n:.4f}), SDPA backward {lib:.4f} / "
          f"{lib_n:.4f} ms", flush=True)
    del o_n, lse_n, delta_n
    # the function's work at these inputs: every visible (query, key) pair
    # of every head; the forward does 2 products of 2*D operations per
    # pair, dQ 3 (q.k, dO.v, ds.k), dK/dV 4 (q.k, dO.v, p^T dO, ds^T q)
    pairs = b * h * sum(min(sk, i + 1) for i in range(sq))
    e = 2                                                  # bf16 bytes
    n_q, n_kv, rows = q.numel(), k.numel(), b * h * sq
    fwd_bound, fwd_by = bound(e * (2 * n_q + 2 * n_kv) + 4 * rows,
                              2 * 2 * d * pairs, H100_BF16_FLOPS)
    print(f"[time] flash_attention_fwd at the training shape: kernel "
          f"{ms_fwd:.4f} ms, plain {plain_fwd:.4f} ms (bf16 operands), "
          f"library {lib_f:.4f} ms (SDPA forward, expanded KV heads), bound "
          f"{fwd_bound:.4f} ms ({fwd_by}); "
          f"{2 * 2 * d * pairs / ms_fwd / 1e9:.1f} TFLOP/s counted",
          flush=True)
    print(f"[time] flash_attention_fwd at the training shape, causal / "
          f"non-causal: {ms_fwd:.4f} / {ms_fwd_n:.4f} ms (ratio "
          f"{ms_fwd / ms_fwd_n:.4f}), SDPA forward {lib_f:.4f} / "
          f"{lib_f_n:.4f} ms", flush=True)
    dq_bytes = e * (3 * n_q + 2 * n_kv + n_q) + 4 * rows * 2
    dkv_bytes = e * (2 * n_q + 2 * n_kv + 2 * n_kv) + 4 * rows * 2
    shape = (f"B={b} H={h} KV={kvh} D={d} S={sq} causal; library_ms is "
             "SDPA's whole backward on expanded KV heads; plain_ms is the "
             "plain version with bf16 operands")
    out = []
    for name, ms, plain, nbytes, prods, at in (
            ("flash_attention_bwd_dq", ms_dq, plain_dq, dq_bytes, 3, 229),
            ("flash_attention_bwd_dkv", ms_dkv, plain_dkv, dkv_bytes, 4,
             255)):
        b_ms, b_by = bound(nbytes, prods * 2 * d * pairs, H100_BF16_FLOPS)
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/csrc/flash_attention_bwd.cu",
                        replaces=f"src/repro/kernels/flash_attention.py:{at}",
                        max_abs_err=max(errs[name.rsplit("_", 1)[1]]),
                        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib, shape=shape))
    print(f"[time] flash attention backward at the training shape: dQ + "
          f"dK/dV {ms_dq + ms_dkv:.4f} ms vs SDPA backward {lib:.4f} ms",
          flush=True)
    del qe, ke, ve
    torch.cuda.empty_cache()
    return out, errs["fwd"]


def check_functions(torch, randn):
    """The autograd Functions on CUDA against autograd through the plain
    forwards, on fp32 copies of the same inputs.  Both sides compute in
    fp32 with different formulas (softmax's autograd vs the flash form
    from lse; autograd of the norm vs its closed form), so the tolerance
    is the fp32 one of the kernel checks, 2e-5 + 2e-5*|ref|."""
    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     flash_attention_fwd_ref)
    from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm_ref
    for label, (b, h, kvh, s, d, window) in (
            ("causal GQA b=2 h=4/2 s=200 d=64", (2, 4, 2, 200, 64, 0)),
            ("windowed=100 h=8/2 s=333 d=32", (1, 8, 2, 333, 32, 100))):
        q = randn(b, s, h, d, dtype=torch.float32).transpose(1, 2)
        k = randn(b, s, kvh, d, dtype=torch.float32).transpose(1, 2)
        v = randn(b, s, kvh, d, dtype=torch.float32).transpose(1, 2)
        do = randn(b, h, s, d, dtype=torch.float32)
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = FlashAttention.apply(*ins, True, window, 0)
        if out.grad_fn is None:
            fail("FlashAttention: no grad_fn on CUDA")
        got = torch.autograd.grad(out, ins, do)
        ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref_out, _ = flash_attention_fwd_ref(*ref_ins, causal=True,
                                             window=window)
        want = torch.autograd.grad(ref_out, ref_ins, do)
        for n, a, w in zip(("dq", "dk", "dv"), got, want):
            compare(torch, f"FlashAttention grad {n} {label}", a, w, 2e-5,
                    2e-5)
    # K3's Function (the Triton forward and backward) at 512 rows and at
    # the training shape, 8192 rows of 2048.  There dgain is a sum over
    # 8192 rows whose partial sums are far larger than the result, so the
    # two summation orders differ by more than 2e-5 of it elementwise: it
    # is held by relative norm (``RMS_DGAIN_REL_NORM``), dx elementwise
    for rows in (512, 8192):
        x = randn(rows, 2048, dtype=torch.float32)
        g = randn(2048, dtype=torch.float32, scale=0.1)
        dy = randn(rows, 2048, dtype=torch.float32)
        xa, ga = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
        y = RMSNorm.apply(xa, ga, 1e-6)
        if y.grad_fn is None:
            fail("RMSNorm: no grad_fn on CUDA")
        got = torch.autograd.grad(y, (xa, ga), dy)
        xr, gr = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
        want = torch.autograd.grad(rmsnorm_ref(xr, gr), (xr, gr), dy)
        compare(torch, f"RMSNorm grad dx rows={rows} d=2048", got[0],
                want[0], 2e-5, 2e-5)
        if rows == 512:
            compare(torch, f"RMSNorm grad dgain rows={rows} d=2048", got[1],
                    want[1], 2e-5, 2e-5)
        else:
            rel_norm(torch, f"RMSNorm grad dgain rows={rows} d=2048", got[1],
                     want[1], RMS_DGAIN_REL_NORM)


def check_backward_at(torch, randn, tol, suffix, label, b, h, kvh, sq, sk,
                      d, causal, window):
    """K5a and K5b at one training shape of a main path, q (b, h, sq, d)
    over k, v (b, kvh, sk, d) bf16 in the model's layout (no offset;
    causal only at Sq = Sk, where ``window`` > 0 limits each query to its
    last ``window`` keys): the K2 output they start from held against the
    plain forward (:func:`check_fwd`), then held as :func:`check_backward`
    holds the bf16 kernels (relative norm against the plain versions with
    bf16 and fp32 operands), launched twice for bit-equal results, and
    timed beside the plain versions and SDPA's whole backward, with the
    bound of what these inputs need (a window's pairs only).  With a
    window SDPA needs a mask, which takes it off its fast path: the
    record's library time is the masked call's, and the ``is_causal``
    call at the same shape (window 0) is printed beside it.  Returns the
    records ``flash_attention_bwd_dq_<suffix>`` and ``..._dkv_<suffix>``
    and K2's max abs error."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_dkv_ref, flash_attention_dq_ref)
    assert sq == sk or not causal
    bf16 = torch.bfloat16
    kw = dict(causal=causal, window=window)
    q, do = (randn(b, sq, h, d).transpose(1, 2) for _ in range(2))
    k, v = (randn(b, sk, kvh, d).transpose(1, 2) for _ in range(2))
    fwd_err, o, lse = check_fwd(torch, label, q, k, v,
                                dict(kw, q_offset=0), tol)

    def both():
        dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
        return (dq, delta) + flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                                     **kw)

    dq, delta, dk, dv = both()
    torch.cuda.synchronize()
    name = f"flash_attention_bwd {{}} {label}"
    dq_f, delta_r = flash_attention_dq_ref(q, k, v, o, lse, do, **kw)
    compare(torch, f"flash_attention_bwd delta {label}", delta, delta_r,
            1e-4, 1e-5, rerun=lambda: both()[1])
    dq_b, _ = flash_attention_dq_ref(q, k, v, o, lse, do, operand_dtype=bf16,
                                     **kw)
    worst = {"dq": check_bf16_grad(torch, name.format("dq"), dq, dq_b, dq_f,
                                   tol[bf16])[0]}
    del dq_f, dq_b
    torch.cuda.empty_cache()
    want_f = flash_attention_dkv_ref(q, k, v, lse, delta_r, do, **kw)
    want_b = flash_attention_dkv_ref(q, k, v, lse, delta_r, do,
                                     operand_dtype=bf16, **kw)
    worst["dkv"] = max(
        check_bf16_grad(torch, name.format(n), got, wb, wf, tol[bf16])[0]
        for n, got, wb, wf in zip(("dk", "dv"), (dk, dv), want_b, want_f))
    del want_f, want_b, delta_r, dq, dk, dv
    torch.cuda.empty_cache()
    same_twice(torch, f"flash_attention_bwd dq, delta, dk, dv {label}", both)
    few = dict(iters=3, reps=3)
    ms = {"dq": timed_ms(torch, lambda: flash_attention_bwd_dq(
              q, k, v, o, lse, do, **kw)),
          "dkv": timed_ms(torch, lambda: flash_attention_bwd_dkv(
              q, k, v, lse, delta, do, **kw))}
    plain = {"dq": timed_ms(torch, lambda: flash_attention_dq_ref(
                 q, k, v, o, lse, do, operand_dtype=bf16, **kw), **few),
             "dkv": timed_ms(torch, lambda: flash_attention_dkv_ref(
                 q, k, v, lse, delta, do, operand_dtype=bf16, **kw), **few)}
    qe, ke, ve = (t.detach().requires_grad_(True) for t in (q, k, v))

    def lib_bwd(mask):
        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(
                    qe, ke, ve, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True)

        def fwd_bwd():
            out = F.scaled_dot_product_attention(
                qe, ke, ve, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
            torch.autograd.grad(out, (qe, ke, ve), do)

        return timed_ms(torch, fwd_bwd, **few) - timed_ms(torch, fwd, **few)

    lib = lib_bwd(sdpa_mask(torch, sq, window, q.device) if window else None)
    if window:
        print(f"[time] SDPA's whole backward {label}: {lib:.4f} ms with the "
              f"window's mask (the record's), {lib_bwd(None):.4f} ms "
              f"is_causal without a window", flush=True)
    pairs = b * h * attended_pairs(sq, sk, causal, window)
    n_q, n_kv, rows = q.numel(), k.numel(), b * h * sq
    nbytes = {"dq": 2 * (4 * n_q + 2 * n_kv) + 4 * rows * 2,
              "dkv": 2 * (2 * n_q + 4 * n_kv) + 4 * rows * 2}
    out = []
    for part, prods, at in (("dq", 3, 229), ("dkv", 4, 255)):
        b_ms, b_by = bound(nbytes[part], prods * 2 * d * pairs,
                           H100_BF16_FLOPS)
        out.append(dict(
            name=f"flash_attention_bwd_{part}_{suffix}", route="cuda",
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces=f"src/repro/kernels/flash_attention.py:{at}",
            max_abs_err=worst[part], ms=ms[part], plain_ms=plain[part],
            bound_ms=b_ms, bound_by=b_by, library_ms=lib,
            shape=f"B={b} H={h} KV={kvh} D={d} Sq={sq} Sk={sk} "
                  f"{'causal' if causal else 'non-causal'}"
                  f"{f' window={window}' if window else ''} ({label}); "
                  "library_ms is SDPA's whole backward"
                  f"{' given the mask' if window else ''}; plain_ms is the "
                  "plain version with bf16 operands"))
    print(f"[time] flash attention backward {label}: dQ {ms['dq']:.4f} + "
          f"dK/dV {ms['dkv']:.4f} ms vs SDPA backward {lib:.4f} ms; bounds "
          f"{out[0]['bound_ms']:.4f} + {out[1]['bound_ms']:.4f} ms | "
          f"{card_line()}", flush=True)
    del qe, ke, ve, q, k, v, o, lse, do, delta
    torch.cuda.empty_cache()
    return out, fwd_err


# the training shapes of phases 14, 18 and 19 that check_backward does
# not hold: zamba2-2.7b's head dim 80, phi-3-vision's 96 and qwen2-moe's
# 128 at G = 1, causal over 4096 tokens; whisper-base's cross attention
# (4096 decoder rows over 1500 frames, a ragged key tail: 1500 = 23 x 64 +
# 28) and its encoder, non-causal; gemma3-12b's microbatch of one
# sequence at head dim 256, a local layer (window 1024) and a global one.
# The last field is the window
TRAIN_BWD_CASES = (
    ("d80", "zamba2 training shape b=2 h=32/32 s=4096 d=80", 2, 32, 32,
     4096, 4096, 80, True, 0),
    ("d96", "phi-3-vision training shape b=2 h=32/32 s=4096 d=96", 2, 32, 32,
     4096, 4096, 96, True, 0),
    ("d128", "qwen2-moe training shape b=2 h=16/16 s=4096 d=128", 2, 16, 16,
     4096, 4096, 128, True, 0),
    ("whisper_train", "whisper cross training shape b=2 h=8/8 sq=4096 "
     "sk=1500 d=64 non-causal", 2, 8, 8, 4096, 1500, 64, False, 0),
    ("whisper_enc_train", "whisper encoder training shape b=2 h=8/8 s=1500 "
     "d=64 non-causal", 2, 8, 8, 1500, 1500, 64, False, 0),
    ("d256_local", "gemma3 local training shape b=1 h=16/8 s=4096 d=256 "
     "window=1024", 1, 16, 8, 4096, 4096, 256, True, 1024),
    ("d256_global", "gemma3 global training shape b=1 h=16/8 s=4096 d=256",
     1, 16, 8, 4096, 4096, 256, True, 0),
)


def check_backward_shapes(torch, randn, tol):
    """K5a and K5b at the training shapes of phases 14, 18 and 19
    (``TRAIN_BWD_CASES``, :func:`check_backward_at`), and K2 at whisper's
    cross shape and gemma3's two as a training forward, timed beside its
    plain version and SDPA (given the window's mask in a local layer):
    the ``*_d80``, ``*_d96``, ``*_d128``, ``*_whisper_train``,
    ``*_whisper_enc_train``, ``*_d256_local`` and ``*_d256_global``
    backward records and ``flash_attention_fwd_whisper_train``,
    ``..._d256_local_train`` and ``..._d256_global_train`` (launches from
    phase 14's run and the runs of phases 18 and 19, the whisper and
    gemma3 ones by call shape)."""
    records = []
    for suffix, label, *shape in TRAIN_BWD_CASES:
        recs, fwd_err = check_backward_at(torch, randn, tol, suffix, label,
                                          *shape)
        records += recs
        if suffix not in ("whisper_train", "d256_local", "d256_global"):
            continue
        b, h, kvh, sq, sk, d, causal, window = shape
        q = randn(b, sq, h, d).transpose(1, 2)
        k, v = (randn(b, sk, kvh, d).transpose(1, 2) for _ in range(2))
        ms, plain, lib, b_ms, b_by = _fwd_times(torch, q, k, v, causal,
                                                window)
        print(f"[time] flash_attention_fwd {label}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms (bf16 operands), library {lib:.4f} ms "
              f"(SDPA{', given the mask' if window else ''}), bound "
              f"{b_ms:.4f} ms ({b_by}) | {card_line()}", flush=True)
        name = suffix if suffix == "whisper_train" else f"{suffix}_train"
        records.append(dict(
            name=f"flash_attention_fwd_{name}", route="cuda",
            source="src/repro_torch/csrc/flash_attention_fwd.cu",
            replaces="src/repro/kernels/flash_attention.py:96",
            max_abs_err=fwd_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib,
            shape=f"{label} (B={b} H={h} KV={kvh} D={d} Sq={sq} Sk={sk}"
                  f"{f' window={window}' if window else ''}); plain_ms is "
                  "the plain version with bf16 operands"
                  f"{'; library_ms is SDPA given the mask' if window else ''}"
        ))
        del q, k, v
        torch.cuda.empty_cache()
    return records


# SSDScan/WKV on the card against autograd through the plain versions, on
# fp32 copies of the same bf16 inputs.  The forward is the bf16 kernel
# (held by SCAN_REL_NORM); the backward works in fp32 from the kernel's
# chunk-start states, so it inherits their summation-order difference, and
# it rounds the gradients of the bf16 inputs to bf16 once (2^-9 of each
# value, ~2e-3 relative norm); the limit is 2.5x that sum
SCAN_GRAD_REL_NORM = 1e-2


def device_ms(torch, fn, calls=3):
    """Device time of one call of ``fn`` (all its CUDA kernels summed),
    from ``torch.profiler`` over ``calls`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()) / 1e3 / calls


def check_scan_grads(torch, randn):
    """The ``SSDScan`` and ``WKV`` Functions' gradients of all five inputs
    (with a gradient of the final state) against autograd through
    ``ssd_scan_ref`` / ``rwkv6_wkv_ref``, at zamba2's and rwkv6-7b's head
    shapes over 1000 tokens and a ragged 333 at batch 2, by
    ``SCAN_GRAD_REL_NORM``; then the forward kernel's and the backward's
    time at the training shapes, (2, 80, 4096, 64) and (2, 64, 4096,
    64)."""
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import ssd_scan as ssd
    bf16 = torch.bfloat16
    scans = (
        ("ssd_scan", ssd.SSDScan, ssd.ssd_scan_ref, ssd.ssd_scan,
         ssd.ssd_scan_bwd,
         lambda b, s: _ssd_inputs(torch, randn, b, 80, s, 64, 64, bf16)),
        ("rwkv6_wkv", wkv.WKV, wkv.rwkv6_wkv_ref, wkv.rwkv6_wkv,
         wkv.rwkv6_wkv_bwd,
         lambda b, s: _wkv_inputs(torch, randn, b, 64, s, 64, bf16)))
    for name, fn, ref, kernel, bwd, make in scans:
        for b, s in ((1, 1000), (2, 333)):
            ins = make(b, s)
            out, state = ref(*ins)
            dout, dstate = randn(*out.shape, dtype=torch.float32), \
                randn(*state.shape, dtype=torch.float32)

            def grads(f, cast):
                leaves = [cast(t).detach().requires_grad_(True) for t in ins]
                o, st = f(*leaves)
                return torch.autograd.grad(
                    (o * dout).sum() + (st * dstate).sum(), leaves)

            got = grads(fn.apply, lambda t: t)
            if any(g.dtype != t.dtype for g, t in zip(got, ins)):
                fail(f"{name}: gradient dtypes differ from the inputs'")
            want = grads(ref, lambda t: t.float())
            for arg, g, w in zip(range(5), got, want):
                rel_norm(torch, f"{fn.__name__} gradient of input {arg} B={b} "
                         f"S={s}", g, w, SCAN_GRAD_REL_NORM)
            del got, want
            torch.cuda.empty_cache()
        ins = make(2, 4096)
        _, _, states = kernel(*ins, chunk_states=True)
        dout = randn(*ins[0].shape, dtype=torch.float32)
        fwd = timed_ms(torch, lambda: kernel(*ins))
        wall = timed_ms(torch, lambda: bwd(*ins, states, dout, None),
                        iters=3, reps=3)
        busy = device_ms(torch, lambda: bwd(*ins, states, dout, None))
        print(f"[time] {name} at the training shape {tuple(ins[0].shape)} "
              f"bf16: forward kernel {fwd:.4f} ms; {fn.__name__} backward "
              f"(PyTorch ops from the kernel's chunk-start states) "
              f"{wall:.4f} ms a call, device busy {busy:.4f} ms of it | "
              f"{card_line()}", flush=True)
        del ins, states, dout
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: full-width tinyllama-1.1b through the engine
# ---------------------------------------------------------------------------

def serve_full(torch):
    from repro_torch.launch.serve import serve
    kernels = _paged_kernels()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with row_copies() as seen:
        out = serve("tinyllama-1.1b", device="cuda", requests=8, max_batch=8,
                    pool_pages=128, prompt_range=(64, 1024), max_new=32,
                    seed=0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    no_row_copies("serve", seen)
    stats, runner, reqs = out["stats"], out["runner"], out["requests"]
    vocab = runner.cfg.vocab_size
    for r in reqs:
        toks = r.output_tokens or []
        if len(toks) != 33 or not all(0 <= t < vocab for t in toks):
            fail(f"serve: {r.req_id} returned {len(toks)} tokens "
                 f"(expected 1 + 32 in [0, {vocab}))")
    lens = [r.prompt_len for r in reqs]
    if not (min(lens) <= 512 < max(lens)):
        fail(f"serve: prompts {lens} do not exercise both prefill paths")
    n_layers = runner.cfg.num_layers
    want = _expected_paged(runner, stats)
    print(f"[serve] tinyllama-1.1b full width, prompts {lens}, "
          f"prefills={stats.prefills} chunks={runner.prefill_chunks} "
          f"decode_steps={stats.decode_steps} launches={launches} "
          f"expected={want}", flush=True)
    if launches != want or not all(launches.values()):
        fail("serve: kernel launch counts differ from what the path implies")
    RMS_LAUNCHES["prefill"] += (2 * n_layers * runner.prefill_chunks
                                + stats.prefills)
    RMS_LAUNCHES["decode"] += (2 * n_layers + 1) * stats.decode_steps
    print(f"[serve] mean_ttft={stats.mean_ttft_s * 1e3:.3f} ms "
          f"mean_decode_step={stats.mean_decode_step_s * 1e3:.3f} ms "
          f"tokens/s={stats.tokens_generated / stats.wall_s:.2f} "
          f"wall={wall:.3f} s peak_mem="
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    return launches


def _paged_kernels():
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    return {"paged_attention": paged_attention,
            "flash_attention_fwd": flash_attention_fwd,
            "rmsnorm": rmsnorm}


def _norms_per_layer(cfg):
    """K3 launches of one attention layer: its two norms, and q_norm and
    k_norm where the config has them (gemma3)."""
    return 4 if cfg.use_qk_norm else 2


def _expected_paged(runner, stats):
    """Launches the paged path implies: K1 in every layer of every decode
    step, K2 in every layer of every prefill chunk, K3 at each block's
    norms of every chunk and step plus ln_f once a prefill and a step."""
    n_layers = runner.cfg.num_layers
    norms = _norms_per_layer(runner.cfg) * n_layers
    return {"paged_attention": n_layers * stats.decode_steps,
            "flash_attention_fwd": n_layers * runner.prefill_chunks,
            "rmsnorm": (norms * (runner.prefill_chunks + stats.decode_steps)
                        + stats.prefills + stats.decode_steps)}


def profile_serve(torch):
    """Device busy share and device time by kernel over one serve run
    (8 requests, 8 new tokens) under ``torch.profiler``.  Prints "not
    measured" when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = serve("tinyllama-1.1b", device="cuda", requests=8, max_batch=8,
                    pool_pages=128, prompt_range=(64, 1024), max_new=8,
                    seed=0, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = out["stats"]
    report_profile(prof, wall, f"serve 8 req x 8 new (decode_steps "
                               f"{stats.decode_steps}, prefill chunks "
                               f"{out['runner'].prefill_chunks})")


# ---------------------------------------------------------------------------
# phase 4: reduced tinyllama, CUDA against CPU, same weights and prompts
# ---------------------------------------------------------------------------

def parity_reduced(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PagePool, Request
    from repro_torch.serving.model_runner import PagedRunner

    cfg = reduced_config(get_config("tinyllama-1.1b"))
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    lens = [200, 700, 96, 513]
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n))
               for n in lens]

    def run(device):
        dev_params = {k: _tree_to(v, device) for k, v in params.items()}
        runner = PagedRunner(cfg, pool_pages=32, max_batch=4,
                             params=dev_params, device=device,
                             record_margins=True)
        eng = ServingEngine(PagePool(32, policy="fixed"), max_batch=4,
                            runner=runner)
        reqs = [Request(f"p{i}", n, 8, prompt_tokens=p)
                for i, (n, p) in enumerate(zip(lens, prompts))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        return {r.req_id: r.output_tokens for r in reqs}, runner.margins

    cuda_toks, _ = run("cuda")
    cpu_toks, margins = run("cpu")
    flips = check_parity(cpu_toks, cuda_toks, margins, TIE_GAP)
    print(f"[parity] reduced tinyllama-1.1b cuda vs cpu: {len(lens)} "
          f"requests, near-tie flips={flips}, min gap "
          f"{min(min(m) for m in margins.values()):.3e}", flush=True)
    parity_rings_reduced(torch)


def parity_rings_reduced(torch):
    """Reduced gemma3-12b (5 local : 1 global, window 8, rings of 2 pages)
    on the paged backend with ring pages, CUDA against CPU, the same
    weights and prompts: prompts of 200 and 90 tokens and 70 new, so the
    generations pass the ring of 2 x 128 tokens and wrap it; tokens equal
    under the ``TIE_GAP`` rule."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PageGroups, PagePool, Request
    from repro_torch.serving.model_runner import PagedRunner

    cfg = reduced_config(get_config("gemma3-12b"))
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    lens = [200, 90]
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n))
               for n in lens]

    def run(device):
        runner = PagedRunner(cfg, pool_pages=32, max_batch=4,
                             params=_tree_to(params, device), device=device,
                             record_margins=True)
        eng = ServingEngine(PagePool(32, policy="fixed",
                                     groups=PageGroups.from_config(cfg)),
                            max_batch=4, runner=runner)
        reqs = [Request(f"g{i}", n, 70, prompt_tokens=p)
                for i, (n, p) in enumerate(zip(lens, prompts))]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        if not runner.use_rings or eng.pool.used_local:
            fail("parity: reduced gemma3 did not serve from ring pages, or "
                 "left ring pages held")
        return {r.req_id: r.output_tokens for r in reqs}, runner.margins

    cuda_toks, _ = run("cuda")
    cpu_toks, margins = run("cpu")
    flips = check_parity(cpu_toks, cuda_toks, margins, TIE_GAP)
    print(f"[parity] reduced gemma3-12b rings cuda vs cpu: prompts {lens}, "
          f"70 new (past the ring of 256 tokens), near-tie flips={flips}, "
          f"min gap {min(min(m) for m in margins.values()):.3e}", flush=True)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def step_grads(torch, model, plan, params, batch, metrics=None):
    """The gradients one train step takes (``make_train_step``'s
    arithmetic: microbatch i takes rows i::mb of every key, fp32 sums
    divided by mb; a leaf the batch does not reach takes zeros), computed
    here with ``model.loss_fn`` and autograd -> a list of fp32 tensors in
    the params' leaf order.  ``metrics``, a dict, gets the loss's ``ce``
    and ``aux`` averaged over the microbatches."""
    from repro_torch.training.optimizer import leaves, tree_map
    mb = max(plan.microbatch, 1)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves(params)]
    for i in range(mb):
        tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, m = model.loss_fn(tracked, {k: v[i::mb]
                                          for k, v in batch.items()})
        if metrics is not None:
            for k in ("ce", "aux"):
                metrics[k] = metrics.get(k, 0.0) + float(m[k]) / mb
        for a, g in zip(acc, torch.autograd.grad(loss, leaves(tracked),
                                                 allow_unused=True)):
            if g is not None:
                a.add_(g)
    return [a.div_(mb) for a in acc]


def _train_kernels():
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq,
                                                     flash_attention_fwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd,
            "ssd_scan": ssd_scan, "rwkv6_wkv": rwkv6_wkv}


# ---------------------------------------------------------------------------
# phase 5: full-width tinyllama-1.1b training
# ---------------------------------------------------------------------------

def train_full(torch):
    """tinyllama-1.1b at full width (random weights from seed 0), sequence
    4096 with the global batch cut from 256 to 8, 4 microbatches of 2
    under full remat (``overrides`` on the ladder's plan), 4 AdamW steps,
    through ``Cluster.submit`` (:func:`train_phase`).  Returns the launch
    counts."""
    from repro_torch.configs import get_config
    cfg = get_config("tinyllama-1.1b")
    _, overrides, _, _ = _train_setup()
    launches, _ = train_phase(torch, "train", cfg, overrides,
                              _attention_counts(cfg.num_layers))
    RMS_LAUNCHES["train"] += launches["rmsnorm"]
    return launches


def train_phase(torch, tag, cfg, overrides, per_mb, unreached=(),
                steps=None, direct=False):
    """One full-width training run of ``cfg`` (random weights from seed
    0) at phase 5's sequence 4096 x batch 8 and optimizer with the plan
    ``overrides``, ``steps`` steps (phase 5's 4 unless given): through
    ``launch.train`` (``Cluster.submit``) on ``SyntheticLM``'s batches,
    or with ``direct`` through the port's ``make_train_step`` on
    ``materialize``'s plan (:func:`train_steps`) with the frontend's
    seeded inputs in each batch (:func:`frontend_inputs`; phi-3: 576
    image embeddings ahead of 3520 tokens; whisper: 1500 frames).  Gates:
    every step-1 gradient leaf finite and not all zero (computed here,
    before the run, from the same weights and batch as the run's first
    step; the leaves named in ``unreached``, which these batches do not
    reach, exactly zero instead); every loss finite and the last below
    the first; every kernel's launch count ``per_mb`` (a microbatch's; 0
    where absent) times the microbatches and steps; no flash-attention
    operand copied for alignment; the measured peak covered by the job's
    grant (``launch.train``, whose plan must be the ladder's with
    ``overrides``; the ladder's own plan is printed beside it) or within
    the card (``direct``).  An MoE config also prints the step-1 batch's
    ``ce`` and ``aux`` and the (token, k) pairs the experts' capacity
    dropped in each step.  Then the step time, tokens/s and model-FLOPs
    share, and one more step under ``torch.profiler``
    (:func:`report_train`).  Returns the launch counts and the
    flash-attention launches by call shape (:func:`train_call_classes`)."""
    from repro_torch.core.materializer import H100, materialize
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import train
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.train_step import impl_from_plan
    t_phase = time.perf_counter()
    kernels = _train_kernels()
    shape, _, ocfg, default_steps = _train_setup()
    steps = steps or default_steps
    plan = materialize(cfg, shape, H100, overrides=overrides)
    model = Model(cfg, impl_from_plan(plan))
    n_img = cfg.num_image_tokens if direct and cfg.family == "vlm" else 0
    data = SyntheticLM(DataConfig(cfg.vocab_size, shape.seq_len - n_img,
                                  shape.global_batch))

    def batch_at(i):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch_at(i).items()}
        if direct:
            batch.update(frontend_inputs(torch, cfg, shape.global_batch, i,
                                         "cuda"))
        return batch

    # step 1's gradients: both runs start from init_params(cfg, 0) and the
    # data's batch 0
    params = init_params(cfg, 0, "cuda")
    m1 = {}
    grads = step_grads(torch, model, plan, params, batch_at(0), m1)
    bad = gradient_faults(torch, params, grads, unreached)
    checked = len(grads)
    del grads
    if not direct:
        params = None                     # train() makes its own
    print(f"[{tag}] step-1 gradients: {time.perf_counter() - t_phase:.1f} s"
          + (f"; the step-1 batch's ce {m1['ce']:.6f}, aux {m1['aux']:.6f} "
             "(loss = ce + 0.01 aux)" if cfg.moe is not None else ""),
          flush=True)
    if bad:
        fail(f"{tag}: step 1 gradients of {bad} (of {checked} leaves) are "
             "not finite or all zero (or, unreached, not zero)")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for fn in kernels.values():
        fn.launches = 0
    with row_copies() as seen, moe_drop_log() as drops, \
            train_call_classes() as classes:
        if direct:
            out = train_steps(torch, tag, model, plan, params, ocfg, steps,
                              batch_at)
        else:
            out = train(cfg, shape=shape, overrides=overrides, opt_cfg=ocfg,
                        device="cuda", steps=steps, seed=0)
        torch.cuda.synchronize()
    del params
    launches = {name: fn.launches for name, fn in kernels.items()}
    no_row_copies(tag, seen)
    if cfg.moe is not None:
        print_drops(tag, drops, steps, plan.remat)
    peak = torch.cuda.max_memory_allocated()
    if direct:
        print(f"[{tag}] {cfg.name} ({cfg.num_layers} layers): plan "
              f"(overrides {overrides}) est "
              f"{plan.est_bytes_per_device / 2**30:.3f} GiB/device, "
              f"measured peak {peak / 2**30:.3f} GiB "
              f"(torch.cuda.max_memory_allocated; {base / 2**30:.3f} GiB "
              f"allocated before the optimizer state) | {card_line()}",
              flush=True)
        if peak > H100.hbm_per_device:
            fail(f"{tag}: the measured peak {peak} passes the card's "
                 f"{H100.hbm_per_device} bytes")
    else:
        ladder = materialize(cfg, shape, H100)
        if out["plan"].describe() != plan.describe():
            fail(f"{tag}: the cluster's plan {out['plan'].describe()} is "
                 f"not the ladder's with {overrides}")
        print(f"[{tag}] {cfg.name} ({cfg.num_layers} layers): the ladder's "
              f"own plan for {shape.name}: remat={ladder.remat} microbatch="
              f"{ladder.microbatch} est "
              f"{ladder.est_bytes_per_device / 2**30:.3f} GiB/device "
              f"({ladder.notes}); the run's plan (overrides {overrides}): "
              f"est {plan.est_bytes_per_device / 2**30:.3f} GiB/device, "
              f"measured peak {peak / 2**30:.3f} GiB "
              f"(torch.cuda.max_memory_allocated); the job's grant "
              f"{out['grant'] / 2**30:.3f} GiB over "
              f"{out['held'] / 2**30:.3f} GiB held ({base / 2**30:.3f} GiB "
              f"allocated before) | {card_line()}", flush=True)
        if not out["grant"] >= out["held"] >= peak - base:
            fail(f"{tag}: the job's grant {out['grant']} does not cover "
                 f"the measured peak {peak} ({out['held']} held)")
    losses = [m["loss"] for m in out["metrics"]]
    want = {k: per_mb.get(k, 0) * plan.microbatch * steps for k in kernels}
    print(f"[{tag}] {cfg.name} full width, seq {shape.seq_len} x batch "
          f"{shape.global_batch} ({n_img} image positions), remat="
          f"{plan.remat} microbatch={plan.microbatch}, losses {losses}, "
          f"launches={launches} expected={want}, by call shape (causal, Sq, "
          f"Sk, window): {classes}, step-1 gradients finite and nonzero on all "
          f"{checked} leaves", flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{tag}: losses {losses} not finite or not decreasing")
    if launches != want:
        fail(f"{tag}: kernel launch counts differ from what the path implies")
    t_report = time.perf_counter()
    report_train(torch, dict(out, shape=shape, n_img=n_img,
                             batch=batch_at(out["cursor"])), peak, ocfg, tag)
    del out
    torch.cuda.empty_cache()
    print(f"[{tag}] phase: {time.perf_counter() - t_phase:.1f} s (the "
          f"profiled step and its report "
          f"{time.perf_counter() - t_report:.1f} s)", flush=True)
    return launches, classes


def train_steps(torch, tag, model, plan, params, ocfg, steps, batch_at):
    """``steps`` steps of the port's ``make_train_step`` from ``params`` on
    ``batch_at(i)``, each step's wall time measured -> the keys of
    ``launch.train``'s result that :func:`train_phase` reads but the
    shape."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step
    opt_state = opt.init_opt_state(params)
    step = make_train_step(model, plan, ocfg)
    metrics = []
    for i in range(steps):
        batch = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        m = {k: float(v) for k, v in m.items()}         # waits for the step
        metrics.append(dict(m, wall_s=time.perf_counter() - t0))
        print(f"[{tag}] step {i}: loss={m['loss']:.4f} grad_norm="
              f"{m['grad_norm']:.4f} ({metrics[-1]['wall_s']:.3f}s)",
              flush=True)
    return dict(metrics=metrics, params=params, opt_state=opt_state,
                model=model, plan=plan, cursor=steps)


def gradient_faults(torch, params, grads, unreached=()):
    """The key paths of the step-1 gradient leaves that are not finite or
    all zero; a leaf named in ``unreached`` must be all zero instead."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths
    bad = []
    for (key, _), g in zip(_flatten_with_paths(params), grads):
        skip = any(u in key for u in unreached)
        if not bool(torch.isfinite(g).all()) or bool(g.any()) == skip:
            bad.append(key)
    return bad


@contextmanager
def moe_drop_log():
    """Each MoE routing's dropped (token, k) pairs, on the card and
    without a sync, in call order, while the block runs."""
    from repro_torch.models import moe as moe_mod
    plain, log = moe_mod.dispatch_slots, []

    def counting(ids, e_total, cap):
        slot, keep = plain(ids, e_total, cap)
        log.append((~keep).sum())
        return slot, keep

    moe_mod.dispatch_slots = counting
    try:
        yield log
    finally:
        moe_mod.dispatch_slots = plain


def print_drops(tag, log, steps, remat):
    """The pairs dropped in each of ``steps`` equal steps of ``log``
    (:func:`moe_drop_log`).  Under remat each MoE block routes twice a
    microbatch, in the forward and in the recompute, to the same ids: the
    pairs a step drops are then half its routings' sum."""
    per = len(log) // steps
    twice = 1 if remat == "none" else 2
    dropped = [int(sum(int(n) for n in log[i * per:(i + 1) * per])) // twice
               for i in range(steps)]
    print(f"[{tag}] (token, k) pairs the experts' capacity dropped in each "
          f"step: {dropped} ({per} routings a step)", flush=True)


def _train_setup():
    """Phase 5's run: sequence 4096, global batch 8 in 4 microbatches under
    full remat, AdamW with one warmup step, 4 steps -> (shape, plan
    overrides, optimizer config, steps)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.training.optimizer import OptimizerConfig
    return (ShapeConfig("train_4k_b8", "train", 4096, 8),
            {"remat": "full", "microbatch": 4},
            OptimizerConfig(warmup_steps=1), 4)


# leaves of the blocks that hold no matmul weight: the depthwise conv and
# RWKV-6's token-shift mixes, decay base, bonus and group-norm gains
NOT_MATMUL = ("conv_w", "mu", "mu_c", "w0", "bonus_u", "ln_x")


def model_flops(cfg, params, shape, n_img=0):
    """A training step's model FLOPs: 6 x the matmul weights applied per
    position x positions, plus attention's products, forward and
    backward.  The stacked blocks' matrices apply at every position of the
    sequence (``n_img`` image positions included), the routed experts' at
    ``top_k`` of the experts a token and the router's at the real experts
    (the padded experts' weights are not the model's), shared experts
    whole; the shared attention block's once per application; whisper's
    encoder and its decoder's cross K/V projections over the
    ``encoder_seq_len`` frames a sequence; phi-3's image projection over
    its image positions; the output head over the text positions (the
    embedding is a gather).  Attention: causal self attention over S(S +
    1)/2 pairs (a sliding-window layer's over the pairs within its
    window), whisper's cross attention over S x frames and its encoder
    over frames x frames.  Remat's recompute, norms, elementwise ops and
    the scans' state arithmetic (K6, K7 and their backward) are not
    counted."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths
    from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL,
                                          ATTN_SHARED, DEC_ATTN, MOE)
    from repro_torch.core.profiles import padded_num_experts
    b, s = shape.global_batch, shape.seq_len
    frames = cfg.encoder_seq_len if cfg.is_encdec else 0
    shared_uses = cfg.pattern.count(ATTN_SHARED) * cfg.num_blocks
    per_pos = per_frame = per_img = per_text = 0.0
    for key, p in _flatten_with_paths(params):
        top, leaf = key.split("/")[0], key.split("/")[-1]
        if top == "blocks" and p.dim() >= 3 and leaf not in NOT_MATMUL:
            if leaf in ("we_gate", "we_up", "we_down", "router"):
                e_pad = padded_num_experts(cfg.moe.num_experts)
                used = cfg.moe.num_experts if leaf == "router" \
                    else cfg.moe.top_k
                per_pos += p.numel() * used / e_pad
            elif leaf in ("cross_wk", "cross_wv"):
                per_frame += p.numel()
            else:
                per_pos += p.numel()
        elif top == "encoder" and p.dim() >= 3:
            per_frame += p.numel()
        elif top == "shared_attn" and p.dim() >= 2:
            per_pos += shared_uses * p.numel()
        elif top == "img_proj":
            per_img += p.numel()
        elif top == "embed" and (leaf == "head" or cfg.tie_embeddings):
            per_text += p.numel()
    weights = b * (per_pos * s + per_frame * frames + per_img * n_img
                   + per_text * (s - n_img))
    self_layers = sum(cfg.pattern.count(k) for k in (
        ATTN_GLOBAL, ATTN_SHARED, MOE, DEC_ATTN)) * cfg.num_blocks
    local_layers = cfg.pattern.count(ATTN_LOCAL) * cfg.num_blocks
    pairs = (self_layers * s * (s + 1) / 2
             + local_layers * attended_pairs(s, s, True, cfg.sliding_window)
             + cfg.pattern.count(DEC_ATTN) * cfg.num_blocks * s * frames
             + cfg.num_encoder_layers * frames * frames)
    return 6 * weights + 3 * 2 * 2 * cfg.head_dim * cfg.num_heads * b * pairs


def report_train(torch, out, peak, ocfg, tag="train"):
    """The step time (median of steps 2 on), tokens/s, peak memory and the
    model-FLOPs share (:func:`model_flops`) of a ``train`` run; then one
    more step under ``torch.profiler``."""
    shape, cfg, steps = out["shape"], out["model"].cfg, len(out["metrics"])
    walls = sorted(m["wall_s"] for m in out["metrics"][1:])
    step_s = walls[len(walls) // 2]
    tokens = shape.seq_len * shape.global_batch
    flops = model_flops(cfg, out["params"], shape, out.get("n_img", 0))
    print(f"[{tag}] step {step_s:.4f} s (median of steps 2-{steps}; all "
          f"{[round(m['wall_s'], 4) for m in out['metrics']]}), "
          f"{tokens / step_s:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB, model FLOPs {flops:.4e} per step "
          f"= {flops / step_s / H100_BF16_FLOPS:.4f} of the bf16 peak "
          f"| {card_line()}", flush=True)
    busy = profile_train(torch, out, ocfg)
    # the profiled step's wall carries the profiler's host overhead, which
    # varies from run to run; the device time against the unprofiled step
    # does not
    if busy is not None:
        print(f"[{tag}] device busy {busy:.3f} ms of the profiled step / "
              f"unprofiled step {step_s * 1e3:.3f} ms = busy share "
              f"{busy / (step_s * 1e3):.4f}", flush=True)


def profile_train(torch, out, ocfg):
    """One more step of the run above under ``torch.profiler`` (on
    ``out["batch"]`` where the run gives one, else the data's next
    batch): the device's busy share and device time by kernel, and for an
    MoE config the device time under the routed experts' forward and
    recompute (``_local_expert_ffn``: the dispatch, the three batched
    products, the combine) and under their products' backward
    (``BmmBackward0``: the only batched products of the model); returns
    the device busy ms."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.training.train_step import make_train_step
    shape, cfg = out["shape"], out["model"].cfg
    step = make_train_step(out["model"], out["plan"], ocfg)
    batch = out.get("batch")
    if batch is None:
        data = SyntheticLM(DataConfig(cfg.vocab_size, shape.seq_len,
                                      shape.global_batch))
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch_at(out["cursor"]).items()}
    torch.cuda.synchronize()
    # the run's cached free blocks back to the card first: near the card's
    # memory a profiled step otherwise fails on a fragmented cache
    torch.cuda.empty_cache()
    with routed_experts_annotated(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = step(out["params"], out["opt_state"], batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total = report_profile(prof, wall, "train 1 step")
    if cfg.moe is not None and total:
        avgs = prof.key_averages()
        fwd_us = routed_experts_us(avgs)
        bwd_us = sum(_device_us(e) for e in avgs if e.key == "BmmBackward0")
        print(f"[profile] routed experts: forward and recompute "
              f"{fwd_us / 1e3:.3f} ms ({100 * fwd_us / 1e3 / total:.1f}%), "
              f"their products' backward {bwd_us / 1e3:.3f} ms "
              f"({100 * bwd_us / 1e3 / total:.1f}%)", flush=True)
    return total


# the ``record_function`` ranges chip_smoke opens under the profiler
ANNOTATIONS = ("moe_routed_experts",)


def _device_us(e):
    """An aggregated profiler event's device time, us."""
    return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))


@contextmanager
def routed_experts_annotated():
    """Each call of the routed experts (``moe._local_expert_ffn``: the
    dispatch, the three batched products, the combine) inside a
    ``record_function`` range named ``ANNOTATIONS[0]`` while the block
    runs."""
    from torch.profiler import record_function
    from repro_torch.models import moe as moe_mod
    plain = moe_mod._local_expert_ffn

    def experts(*args):
        with record_function(ANNOTATIONS[0]):
            return plain(*args)

    moe_mod._local_expert_ffn = experts
    try:
        yield
    finally:
        moe_mod._local_expert_ffn = plain


def routed_experts_us(avgs):
    """The device time (us) of the kernels launched in the host-side
    ranges of :func:`routed_experts_annotated`, from a profile's
    ``key_averages()``."""
    return sum(_device_us(e) for e in avgs if e.key == ANNOTATIONS[0]
               and not str(getattr(e, "device_type", "")).endswith("CUDA"))


def report_profile(prof, wall, what):
    """Busy share and device time by kernel of a profiled window; returns
    the device busy ms (None when not measured)."""
    avgs = prof.key_averages()            # aggregated once: it is slow
    # a ``record_function`` range also shows as a device-side annotation,
    # which spans the kernels it holds: not a kernel of its own
    kernels = [e for e in avgs
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)
               and e.key not in ANNOTATIONS]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
              for e in kernels}
    total_ms = sum(dev_us.values()) / 1e3
    if total_ms <= 0:
        print("[profile] device time not measured: the profiler recorded "
              "no CUDA kernel time", flush=True)
        return None
    print(f"[profile] {what}: wall {wall * 1e3:.3f} ms (under the "
          f"profiler), device busy {total_ms:.3f} ms, busy share "
          f"{total_ms / (wall * 1e3):.4f}", flush=True)
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   {us / 1e3:10.3f} ms  "
              f"{100 * us / 1e3 / total_ms:5.1f}%  {key[:90]}", flush=True)
    # K3: its forward kernels by name, and the device time under the
    # norm's autograd node (the fused backward, or the plain ops it
    # replaced); 0 on a path that takes no gradient
    fwd_us = sum(t for key, t in dev_us.items() if "rmsnorm" in key
                 and "bwd" not in key and "dgain" not in key)
    bwd_us = max((_device_us(e) for e in avgs if "RMSNormBackward" in e.key),
                 default=0.0)
    for name, us in (("K3 rmsnorm forward kernels", fwd_us),
                     ("K3 norm backward (under RMSNormBackward)", bwd_us)):
        if us:
            print(f"[profile]   {us / 1e3:10.3f} ms  "
                  f"{100 * us / 1e3 / total_ms:5.1f}%  {name}", flush=True)
    # K6 and K7 run as three CUDA kernels a call each; K2 and K5 and
    # cuBLAS's GEMM and GEMV kernels (those the scan backward's products
    # launch included) by kernel name
    for name, marks in (("K7 ssd_scan", ("ssd_",)),
                        ("K6 rwkv6_wkv", ("wkv_",)),
                        ("K2 flash forward", ("flash_fwd",)),
                        ("K5a + K5b flash backward", ("flash_bwd",)),
                        ("cuBLAS GEMMs and GEMVs",
                         ("gemm", "gemv", "xmma", "cutlass", "nvjet"))):
        us = sum(t for key, t in dev_us.items()
                 if any(m in key.lower() for m in marks))
        if us:
            print(f"[profile]   {us / 1e3:10.3f} ms  "
                  f"{100 * us / 1e3 / total_ms:5.1f}%  {name}, all its "
                  "kernels", flush=True)
    # the scan gradients: PyTorch ops under the Functions' autograd nodes
    for node in ("SSDScanBackward", "WKVBackward"):
        us = max((_device_us(e) for e in avgs if node in e.key), default=0.0)
        if us:
            print(f"[profile]   {us / 1e3:10.3f} ms  "
                  f"{100 * us / 1e3 / total_ms:5.1f}%  scan backward (under "
                  f"{node})", flush=True)
    return total_ms


def ab_train(parent_root: str) -> None:
    """Phase 5's run and K3's per-class times for another tree of the port
    (``parent_root``, a checkout holding ``src/repro_torch``) and this
    tree, in turns on one card: parent, this, this, parent, each in its
    own process, through this script's harness (``ab_child``)::

        python3 -c "import chip_smoke; chip_smoke.ab_train('build/parent')"
    """
    for root in (parent_root, ROOT, ROOT, parent_root):
        src = str(Path(root).resolve() / "src")
        print(f"[ab] --- {src}", flush=True)
        subprocess.run([sys.executable, "-c", "import sys; sys.path.insert("
                        f"0, {str(ROOT)!r}); import chip_smoke; "
                        f"chip_smoke.ab_child({src!r})"], check=True,
                       timeout=900)


def ab_child(src: str) -> None:
    """One turn of ``ab_train``: the port under ``src`` builds its kernels,
    times K3 at every shape class, and runs phase 5's training (no launch
    checks) with its step time and profile."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.launch.train import train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[ab] {rms.__file__} | {card_line()}", flush=True)
    _build.build()
    time_rmsnorm_classes(torch, rms, torch.Generator(
        device="cuda").manual_seed(11))
    shape, overrides, ocfg, steps = _train_setup()
    torch.cuda.reset_peak_memory_stats()
    if "overrides" in inspect.signature(train).parameters:
        kw = {"overrides": overrides}
    else:                                 # a tree before the runtime port
        from repro_torch.core.materializer import Plan
        kw = {"plan": Plan(**overrides)}
    out = train("tinyllama-1.1b", shape=shape, opt_cfg=ocfg, device="cuda",
                steps=steps, seed=0, **kw)
    torch.cuda.synchronize()
    report_train(torch, out, torch.cuda.max_memory_allocated(), ocfg)


def ab_serve(parent_root: str) -> None:
    """Phase 3's serve (8 requests, prompts 64..1024, 32 new tokens) for
    another tree of the port (``parent_root``) and this tree, in turns on
    one card: parent, this, this, parent, each in its own process, each
    printing its mean TTFT and mean decode step::

        python3 -c "import chip_smoke; chip_smoke.ab_serve('build/parent')"
    """
    for root in (parent_root, ROOT, ROOT, parent_root):
        src = str(Path(root).resolve() / "src")
        print(f"[ab] --- {src}", flush=True)
        subprocess.run([sys.executable, "-c", "import sys; sys.path.insert("
                        f"0, {str(ROOT)!r}); import chip_smoke; "
                        f"chip_smoke.ab_serve_child({src!r})"], check=True,
                       timeout=900)


def ab_serve_child(src: str) -> None:
    """One turn of ``ab_serve``: the port under ``src`` builds its
    kernels, serves phase 3's traffic once with 2 new tokens (first calls
    of the kernels) and then three times as phase 3 does, printing each
    run's mean TTFT and mean decode step."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as launch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[ab] {launch.__file__} | {card_line()}", flush=True)
    _build.build()
    kw = dict(device="cuda", requests=8, max_batch=8, pool_pages=128,
              prompt_range=(64, 1024), seed=0, verbose=False)
    launch.serve("tinyllama-1.1b", max_new=2, **kw)
    for i in range(3):
        stats = launch.serve("tinyllama-1.1b", max_new=32, **kw)["stats"]
        print(f"[ab] serve {i}: mean_ttft={stats.mean_ttft_s * 1e3:.3f} ms "
              f"mean_decode_step={stats.mean_decode_step_s * 1e3:.3f} ms "
              f"decode_steps={stats.decode_steps} wall="
              f"{stats.wall_s:.3f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 6: reduced training, CUDA against CPU, same weights and batches
# ---------------------------------------------------------------------------

# Tolerances of phase 6.  The kernels keep attention probabilities in fp32
# where the plain versions round them to bf16 as the reference does; run on
# the CPU with fp32 probabilities, the same 3 steps moved the losses by
# 6e-6 (relative), the params by 7e-4 and the step-1 gradients by at most
# 2.5e-3 (relative norm).  The rest is the bf16 products' accumulation order
# (cuBLAS against the CPU), about one bf16 ulp (4e-3) per rounding.
TRAIN_LOSS_RTOL = 2e-3
TRAIN_PARAM_RTOL = 1e-2          # relative norm over all parameters
TRAIN_GRAD_RTOL = 5e-2           # relative norm of each step-1 gradient


def parity_train_reduced(torch):
    """Reduced tinyllama-1.1b (2 layers, full remat), zamba2-2.7b (two
    pattern blocks, so the shared attention block runs twice; under
    ``remat="dots"``), rwkv6-7b (2 layers, full remat), qwen2-moe-a2.7b
    and dbrx-132b (2 layers, full remat; 1280 tokens, so the experts'
    capacity drops pairs), phi-3-vision-4.2b (2 layers, full remat, with
    seeded image embeddings), whisper-base (2 decoder layers over its
    2 encoder layers' 16 frames, full remat) and gemma3-12b (one period:
    5 layers of window 8 and a global one, qk-norm, tied embeddings, the
    sqrt(d) embed scale; full remat) each train 3 steps of 2
    microbatches at sequence 160 (ragged over the kernels' 64-row tiles
    and 64-token chunks) from the same weights on the same batches, on
    the card and on the CPU: losses, final params and step-1 gradients
    within ``TRAIN_*_RTOL``."""
    for arch, layers, remat in (("tinyllama-1.1b", 2, "full"),
                                ("zamba2-2.7b", 12, "dots"),
                                ("rwkv6-7b", 2, "full"),
                                ("qwen2-moe-a2.7b", 2, "full"),
                                ("dbrx-132b", 2, "full"),
                                ("phi-3-vision-4.2b", 2, "full"),
                                ("whisper-base", 2, "full"),
                                ("gemma3-12b", 6, "full")):
        parity_train_one(torch, arch, layers, remat)


def frontend_inputs(torch, cfg, batch, step, device, dtype=None):
    """Seeded stand-ins for the stubbed frontends' inputs of one training
    batch, in bf16 (or ``dtype``): phi-3-vision's image embeddings (B,
    num_image_tokens, 1024), whisper's frame features (B,
    encoder_seq_len, d); {} for the other families.  Drawn on the CPU
    from ``step``, so the card and the CPU get the same values."""
    gen = torch.Generator().manual_seed(1000 + step)
    if cfg.family == "vlm":
        shape = (batch, cfg.num_image_tokens, 1024)
        key = "img_feats"
    elif cfg.is_encdec:
        shape = (batch, cfg.encoder_seq_len, cfg.d_model)
        key = "enc_feats"
    else:
        return {}
    return {key: torch.randn(shape, generator=gen).to(
        dtype or torch.bfloat16).to(device)}


@contextmanager
def pinned_routes(torch, record=None, replay=None):
    """Record each MoE routing's expert ids (``record``, a list) or replay
    recorded ones (``replay``): the router's probabilities, weights and
    balance loss are the run's own, gathered at the replayed ids.  A
    routing is a discrete choice: an ulp of difference in a router logit
    can swap a near-tied token's experts, and one swap moves the capacity
    ranks of an expert's later tokens, so gradients are compared on the
    same routing (and the swaps counted)."""
    from repro_torch.models import moe as moe_mod
    plain, seen = moe_mod.route, {"swapped": 0, "tokens": 0}
    pending = iter(replay) if replay is not None else None

    def route(p, x, cfg):
        weights, ids, aux = plain(p, x, cfg)
        if record is not None:
            record.append(ids.detach().cpu())
        if pending is None:
            return weights, ids, aux
        want = next(pending).to(ids.device)
        seen["swapped"] += int((want != ids).any(-1).sum())
        seen["tokens"] += ids.shape[0]
        weights, aux = moe_mod.routed(moe_mod.router_probs(p, x, cfg), want,
                                      cfg, x.dtype)
        return weights, want, aux

    moe_mod.route = route
    try:
        yield seen
    finally:
        moe_mod.route = plain


def parity_train_one(torch, arch, layers, remat):
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.core.materializer import H100, Plan
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model, init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import impl_from_plan, make_train_step

    cfg = reduced_config(get_config(arch), num_layers=layers)
    plan = Plan(cfg.name, "reduced_160", H100, microbatch=2, remat=remat)
    model = Model(cfg, impl_from_plan(plan))
    params0 = init_params(cfg, 0, "cpu")
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    data = SyntheticLM(DataConfig(cfg.vocab_size, 160 - n_img, 8))
    ocfg = opt.OptimizerConfig(warmup_steps=1)
    routes = []                   # the card's step-1 routings, in order

    def run(device):
        step = make_train_step(model, plan, ocfg)
        params = _tree_to(params0, device)
        state = opt.init_opt_state(params)
        losses, grads, swaps = [], None, None
        for i in range(3):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch_at(i).items()}
            batch.update(frontend_inputs(torch, cfg, 8, i, device))
            if grads is None:
                with pinned_routes(torch, *((routes, None) if device == "cuda"
                                            else (None, routes))) as swaps:
                    grads = [g.cpu() for g in step_grads(torch, model, plan,
                                                         params, batch)]
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        return losses, _tree_to(params, "cpu"), grads, swaps

    cuda_losses, cuda_params, cuda_grads, _ = run("cuda")
    cpu_losses, cpu_params, cpu_grads, swaps = run("cpu")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cuda_losses,
                                                      cpu_losses))
    num = sum(float((a.float() - b.float()).square().sum()) for a, b in
              zip(opt.leaves(cuda_params), opt.leaves(cpu_params)))
    den = sum(float(b.float().square().sum())
              for b in opt.leaves(cpu_params))
    param_err = (num / den) ** 0.5
    grad_errs = {key: float((a - b).norm() / b.norm())
                 for (key, _), a, b in zip(_flatten_with_paths(params0),
                                           cuda_grads, cpu_grads)}
    worst = max(grad_errs, key=grad_errs.get)
    routing = (f"; step 1 routed as on the card, the CPU's own routing "
               f"swapping the experts of {swaps['swapped']} of "
               f"{swaps['tokens']} token routings" if routes else "")
    print(f"[parity] reduced {arch} ({layers} layers, remat={remat}) "
          f"training cuda vs cpu, 3 steps: losses {cuda_losses} vs "
          f"{cpu_losses} (max rel {loss_err:.3e} <= {TRAIN_LOSS_RTOL}), "
          f"params rel norm {param_err:.3e} <= {TRAIN_PARAM_RTOL}, step-1 "
          f"grads worst rel norm {grad_errs[worst]:.3e} ({worst}) <= "
          f"{TRAIN_GRAD_RTOL}{routing}", flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_RTOL
            and grad_errs[worst] <= TRAIN_GRAD_RTOL):
        fail(f"parity: CUDA training of reduced {arch} disagrees with the "
             "CPU's plain path")


# ---------------------------------------------------------------------------
# phases 7 and 8: full-width zamba2-2.7b and rwkv6-7b on the dense backend
# ---------------------------------------------------------------------------

def _dense_kernels():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.rwkv6_scan import rwkv6_wkv
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"flash_attention_fwd": flash_attention_fwd,
            "rmsnorm": rmsnorm, "decode_attention": decode_attention,
            "ssd_scan": ssd_scan, "rwkv6_wkv": rwkv6_wkv,
            "paged_attention": paged_attention}


def _expected_dense(cfg, prefills, decode_steps):
    """Launches the dense path implies: per prefill and per decode step,
    one RMSNorm launch per norm of each block plus ln_f; per prefill, K2
    in each attention or MoE block or shared-attention application, K7 in
    each Mamba-2 block and K6 in each RWKV-6 block; per decode step K4 in
    each attention or MoE block or application."""
    from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL,
                                          ATTN_SHARED, MAMBA2, MOE, RWKV6)
    nb = cfg.num_blocks
    count = {k: nb * cfg.pattern.count(k) for k in (MAMBA2, RWKV6,
                                                    ATTN_SHARED, ATTN_GLOBAL,
                                                    ATTN_LOCAL, MOE)}
    attn = count[ATTN_GLOBAL] + count[ATTN_LOCAL] + count[MOE]
    qk = 2 if cfg.use_qk_norm else 0
    norms = (2 * count[MAMBA2] + 2 * count[RWKV6]
             + (3 + qk) * count[ATTN_SHARED] + (2 + qk) * attn + 1)
    return {"flash_attention_fwd": (count[ATTN_SHARED] + attn) * prefills,
            "rmsnorm": norms * (prefills + decode_steps),
            "decode_attention": (count[ATTN_SHARED] + attn) * decode_steps,
            "ssd_scan": count[MAMBA2] * prefills,
            "rwkv6_wkv": count[RWKV6] * prefills,
            "paged_attention": 0}


# phase 16's gate on a serve run's peak: the plan's estimate (weights, the
# dense cache, a decode step's activations) plus what it leaves out, the
# largest piece that init draws at once (``INIT_SLICE_ELEMS``: 1 GiB in
# fp32 and its 0.5 GiB bf16 cast) and a prefill's activations.  A peak
# above it would let the plan admit a co-tenant that cannot fit.
PEAK_OVER_PLAN_BYTES = 2 * 2**30


def serve_dense_full(torch, arch, *, requests=8, prompt_range=(64, 1024),
                     max_new=32, peak_over_plan=None):
    """``arch`` (a name, or a config cut in depth) at full width, random
    weights from seed 0, through ``serve(backend="dense")``: ``requests``
    requests, prompts drawn from ``prompt_range`` (seed 0), ``max_new``
    new tokens, max batch 8, a 2048-token cache per slot.  Prints TTFT,
    the decode step, the peak beside the plan's estimate (and fails if it
    exceeds the estimate by more than ``peak_over_plan`` bytes, where
    given) and, for an MoE config, the tokens its experts dropped at
    prefill and the decode step's weight-read floor.  Returns the launch
    counts of the kernels this path runs; then a profiled run of the same
    traffic with 8 new tokens on the same runner."""
    import gc
    from repro_torch.launch.serve import serve
    kernels = _dense_kernels()
    name = arch if isinstance(arch, str) else \
        f"{arch.name} ({arch.num_layers} of its layers)"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with row_copies() as seen, moe_drops(torch) as drops:
        out = serve(arch, backend="dense", device="cuda", requests=requests,
                    max_batch=8, prompt_range=prompt_range, max_new=max_new,
                    seed=0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    no_row_copies(f"serve {name}", seen)
    stats, runner, reqs = out["stats"], out["runner"], out["requests"]
    cfg = runner.cfg
    for r in reqs:
        toks = r.output_tokens or []
        if (len(toks) != 1 + max_new
                or not all(0 <= t < cfg.vocab_size for t in toks)):
            fail(f"serve {name}: {r.req_id} returned {len(toks)} tokens "
                 f"(expected 1 + {max_new} in [0, {cfg.vocab_size}))")
    want = _expected_dense(cfg, stats.prefills, stats.decode_steps)
    print(f"[serve] {name} full width, dense, prompts "
          f"{[r.prompt_len for r in reqs]}, prefills={stats.prefills} "
          f"decode_steps={stats.decode_steps} launches={launches} "
          f"expected={want}", flush=True)
    if launches != want or not all(n for k, n in launches.items()
                                   if want[k]):
        fail(f"serve {name}: kernel launch counts differ from what the "
             "path implies")
    norms = want["rmsnorm"] // (stats.prefills + stats.decode_steps)
    RMS_LAUNCHES["prefill"] += norms * stats.prefills
    RMS_LAUNCHES["decode"] += norms * stats.decode_steps
    print(f"[serve] {name} mean_ttft={stats.mean_ttft_s * 1e3:.3f} ms "
          f"mean_decode_step={stats.mean_decode_step_s * 1e3:.3f} ms "
          f"tokens/s={stats.tokens_generated / stats.wall_s:.2f} "
          f"wall={wall:.3f} s (weights init included) peak_mem="
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, plan "
          f"estimate {out['plan'].est_bytes_per_device / 2**30:.3f} GiB | "
          f"{card_line()}", flush=True)
    over = torch.cuda.max_memory_allocated() - out["plan"].est_bytes_per_device
    if peak_over_plan is not None and over > peak_over_plan:
        fail(f"serve {name}: peak {over / 2**30:.3f} GiB over the plan's "
             f"estimate (at most {peak_over_plan / 2**30:.3f} GiB)")
    if cfg.moe is not None:
        moe_report(torch, name, runner, stats, drops)
    profile_dense(torch, name, runner, requests, prompt_range)
    del out, runner, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return {k: n for k, n in launches.items() if want[k]}


@contextmanager
def moe_drops(torch):
    """Count, on the card and without a sync, the (token, k) pairs that
    the MoE blocks' capacity drops while the block runs (a decode step of
    at most 8 tokens drops none: every expert takes 8)."""
    from repro_torch.models import moe as moe_mod
    plain, seen = moe_mod.dispatch_slots, {"pairs": None, "calls": 0}

    def counting(ids, e_total, cap):
        slot, keep = plain(ids, e_total, cap)
        n = (~keep).sum()
        seen["pairs"] = n if seen["pairs"] is None else seen["pairs"] + n
        seen["calls"] += 1
        return slot, keep

    moe_mod.dispatch_slots = counting
    try:
        yield seen
    finally:
        moe_mod.dispatch_slots = plain


@contextmanager
def call_classes():
    """Count the model's K2 and K4 launches by call shape while the block
    runs: K2's by (causal, Sq, Sk), K4's by (cache length, head dim).  A
    call counts where its wrapper's own count rose, that is where it
    launched its kernel.  The model reaches both kernels only through
    ``models/attention.py``, whose names are wrapped."""
    from repro_torch.models import attention as attn
    k2, k4 = attn.flash_attention_fwd, attn.decode_attention
    seen = {"flash_attention_fwd": {}, "decode_attention": {}}

    def tally(name, key):
        seen[name][key] = seen[name].get(key, 0) + 1

    def fwd(q, k, v, **kw):
        n = k2.launches
        out = k2(q, k, v, **kw)
        if k2.launches > n:
            tally("flash_attention_fwd",
                  (bool(kw.get("causal", True)), q.shape[2], k.shape[2]))
        return out

    def dec(q, k, v, valid_len):
        n = k4.launches
        out = k4(q, k, v, valid_len)
        if k4.launches > n:
            tally("decode_attention", (k.shape[2], k.shape[3]))
        return out

    attn.flash_attention_fwd, attn.decode_attention = fwd, dec
    try:
        yield seen
    finally:
        attn.flash_attention_fwd, attn.decode_attention = k2, k4


def moe_report(torch, name, runner, stats, drops):
    """The (token, k) pairs the experts dropped over the run's prefills,
    and the decode step against its weight-read floor: every weight but
    the token embedding (the capacity design runs every padded expert's
    products each step, whatever the 8 tokens route to) over the card's
    memory rate."""
    tok = runner.params["embed"]["tok"]
    read = _tree_bytes(runner.params) - tok.numel() * tok.element_size()
    floor_ms = read / H100_BYTES_PER_S * 1e3
    step_ms = stats.mean_decode_step_s * 1e3
    dropped = int(drops["pairs"]) if drops["pairs"] is not None else 0
    print(f"[moe] {name}: (token, k) pairs dropped by the experts' "
          f"capacity over {stats.prefills} prefills: {dropped} "
          f"({drops['calls']} MoE block calls in all); decode step "
          f"{step_ms:.3f} ms against its weight-read floor {floor_ms:.3f} ms "
          f"({read / 2**30:.2f} GiB at {H100_BYTES_PER_S / 1e12:.2f} TB/s): "
          f"{floor_ms / step_ms:.3f} of the floor | {card_line()}",
          flush=True)


def profile_dense(torch, arch, runner, requests=8, prompt_range=(64, 1024)):
    """The phase's traffic with 8 new tokens, on the same runner, under
    ``torch.profiler``: busy share and device time by kernel; for an MoE
    config also the device time under the routed experts' products
    (``_local_expert_ffn``, its dispatch included) against the attention
    kernels'."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PagePool, Request
    rng = np.random.default_rng(0)
    reqs = [Request(f"r{i}", int(rng.integers(prompt_range[0],
                                              prompt_range[1] + 1)), 8)
            for i in range(requests)]
    eng = ServingEngine(PagePool(128), max_batch=8, runner=runner)
    torch.cuda.synchronize()
    with routed_experts_annotated(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        stats = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total = report_profile(prof, wall, f"{arch} dense serve {requests} req "
                                       f"x 8 new (decode_steps "
                                       f"{stats.decode_steps})")
    if runner.cfg.moe is None or not total:
        return
    avgs = prof.key_averages()
    experts_us = routed_experts_us(avgs)
    attn_us = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
                  for e in avgs if any(m in e.key for m in (
                      "flash_fwd", "decode_split", "combine")))
    print(f"[profile] {arch}: device time under the routed experts "
          f"(dispatch, the three batched products, combine) "
          f"{experts_us / 1e3:.3f} ms ({100 * experts_us / 1e3 / total:.1f}%"
          f"), attention kernels (K2 + K4) {attn_us / 1e3:.3f} ms "
          f"({100 * attn_us / 1e3 / total:.1f}%)", flush=True)


# ---------------------------------------------------------------------------
# phase 9: reduced dense serving, CUDA against CPU, same weights and prompts
# ---------------------------------------------------------------------------

def parity_dense_reduced(torch, archs=("zamba2-2.7b", "rwkv6-7b",
                                        "tinyllama-1.1b")):
    """Each reduced config of ``archs`` serves 4 prompts of 9..200 tokens,
    8 new tokens each, on the dense backend with the same weights on the
    card and on the CPU; tokens equal under the ``TIE_GAP`` rule."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PagePool, Request
    from repro_torch.serving.model_runner import DenseRunner
    lens = [200, 9, 77, 130]
    for arch in archs:
        cfg = reduced_config(get_config(arch))
        params = init_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(2)
        prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n))
                   for n in lens]

        def run(device):
            runner = DenseRunner(cfg, max_batch=4, cache_len=256,
                                 params=_tree_to(params, device),
                                 device=device, record_margins=True)
            eng = ServingEngine(PagePool(32, policy="fixed"), max_batch=4,
                                runner=runner)
            reqs = [Request(f"d{i}", n, 8, prompt_tokens=p)
                    for i, (n, p) in enumerate(zip(lens, prompts))]
            for r in reqs:
                eng.submit(r)
            eng.run_to_completion()
            return {r.req_id: r.output_tokens for r in reqs}, runner.margins

        cuda_toks, _ = run("cuda")
        cpu_toks, margins = run("cpu")
        flips = check_parity(cpu_toks, cuda_toks, margins, TIE_GAP)
        print(f"[parity] reduced {arch} dense cuda vs cpu: {len(lens)} "
              f"requests, near-tie flips={flips}, min gap "
              f"{min(min(m) for m in margins.values()):.3e}", flush=True)


# ---------------------------------------------------------------------------
# phases 16 and 17: the MoE, vision-language and encoder-decoder families
# ---------------------------------------------------------------------------

def serve_families_full(torch):
    """Phase 16, each model at full width with random bf16 weights from
    seed 0, each run's weights freed before the next: (a) qwen2-moe-a2.7b
    at full depth and (b) dbrx-132b at 4 of its 40 layers (the full depth
    needs more than one card) through ``launch.serve`` on the dense
    backend (:func:`serve_dense_full`: 8 requests of 64..1024 tokens and
    32 new, and 4 of 256..1024 and 16 new); (c) phi-3-vision-4.2b, 8 text
    requests so, then image tokens through ``Model.prefill``
    (:func:`frontend_run`); (d) whisper-base's frames through
    ``Model.prefill`` (:func:`frontend_run`).  The serve runs' peaks are
    gated against their plans (``PEAK_OVER_PLAN_BYTES``).  Returns the
    launch counts, and those of the ``*_d96`` and ``*_whisper_*``
    records."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    launches, records = {}, {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        return counts

    peak = dict(peak_over_plan=PEAK_OVER_PLAN_BYTES)
    add(serve_dense_full(torch, "qwen2-moe-a2.7b", **peak))
    add(serve_dense_full(torch, get_config("dbrx-132b").scaled(num_layers=4),
                         requests=4, prompt_range=(256, 1024), max_new=16,
                         **peak))
    text = add(serve_dense_full(torch, "phi-3-vision-4.2b", **peak))
    image, _ = frontend_run(torch, "phi-3-vision-4.2b", lanes=2, prompt=128,
                            new=32)
    add(image)
    for k in ("flash_attention_fwd", "decode_attention"):
        records[f"{k}_d96"] = text[k] + image[k]
    audio, classes = frontend_run(torch, "whisper-base", lanes=WHISPER_LANES,
                                  prompt=WHISPER_PROMPT, new=64,
                                  cache_len=448)
    add(audio)
    # the whisper records count the launches at their own call shapes
    wcfg = get_config("whisper-base")
    frames = wcfg.encoder_seq_len
    k2, k4 = classes["flash_attention_fwd"], classes["decode_attention"]
    records["flash_attention_fwd_whisper_enc"] = k2[(False, frames, frames)]
    records["flash_attention_fwd_whisper_cross"] = k2[(False, WHISPER_PROMPT,
                                                       frames)]
    records["decode_attention_whisper_cross"] = k4[(frames, wcfg.head_dim)]
    print(f"[families] phase 16: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, records


def frontend_run(torch, arch, *, lanes, prompt, new, cache_len=2048):
    """``arch`` at full width through ``Model.prefill`` with its stub
    frontend's input -- phi-3-vision's seeded (lanes, 576, 1024) image
    embeddings ahead of the prompt, or whisper's seeded (lanes, 1500, 512)
    frame features -- then ``new`` greedy ``Model.decode_step``s from
    position ``prompt + num_image_tokens``.  Gates: finite logits, tokens
    in the vocabulary, each kernel's launches what the path implies (for
    whisper, K2 in each layer's encoder, self and cross attention a
    prefill and K4 in each layer's self and cross attention a step), and
    the reference's prefill/decode consistency rule
    (``tests/test_arch_smoke.py``: the first decode step's logits within
    rtol 0.15 / atol 0.3 of a prefill over the prompt and that token).
    Returns the launch counts of the kernels the path runs."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, init_params
    from repro_torch.models.transformer import ImplConfig
    cfg = get_config(arch)
    kernels = _dense_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, "cuda")
    model = Model(cfg, ImplConfig(remat="none"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (lanes, prompt), generator=gen,
                         device="cuda")
    if cfg.is_encdec:
        feats = {"enc_feats": torch.randn(
            lanes, cfg.encoder_seq_len, cfg.d_model, generator=gen,
            device="cuda").to(torch.bfloat16)}
    else:
        feats = {"img_feats": torch.randn(
            lanes, cfg.num_image_tokens, 1024, generator=gen,
            device="cuda").to(torch.bfloat16)}
    pos = prompt + cfg.num_image_tokens
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    with call_classes() as classes:
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, toks, cache_len, **feats)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        out = [logits[:, -1].argmax(-1)]
        first = None
        t0 = time.perf_counter()
        for i in range(new):
            logits, cache = model.decode_step(params, out[-1][:, None],
                                              cache, pos + i)
            first = logits[:, -1] if first is None else first
            out.append(logits[:, -1].argmax(-1))
        torch.cuda.synchronize()
        t_decode = (time.perf_counter() - t0) / new
    launches = {k: fn.launches for k, fn in kernels.items()}
    hd, frames = cfg.head_dim, cfg.encoder_seq_len
    if cfg.is_encdec:
        want = {k: 0 for k in kernels}
        want.update(flash_attention_fwd=cfg.num_encoder_layers
                    + 2 * cfg.num_layers,
                    decode_attention=2 * cfg.num_layers * new)
        # K2 in each encoder layer over the frames, in each decoder
        # layer's self attention over the prompt and its cross attention
        # over the frames; K4 over the self cache and over the frames
        want_classes = {"flash_attention_fwd": {}, "decode_attention": {}}
        for kernel, key, n in (
                ("flash_attention_fwd", (False, frames, frames),
                 cfg.num_encoder_layers),
                ("flash_attention_fwd", (True, prompt, prompt), cfg.num_layers),
                ("flash_attention_fwd", (False, prompt, frames),
                 cfg.num_layers),
                ("decode_attention", (cache_len, hd), cfg.num_layers * new),
                ("decode_attention", (frames, hd), cfg.num_layers * new)):
            want_classes[kernel][key] = want_classes[kernel].get(key, 0) + n
    else:
        want = _expected_dense(cfg, 1, new)
        want_classes = {
            "flash_attention_fwd": {(True, pos, pos): cfg.num_layers},
            "decode_attention": {(cache_len, hd): cfg.num_layers * new}}
    gen_toks = torch.stack(out, 1)
    print(f"[families] {arch} full width via Model.prefill ({lanes} lanes, "
          f"{prompt}-token prompt, {sorted(feats)[0]} "
          f"{tuple(next(iter(feats.values())).shape)}), {new} decode steps "
          f"from position {pos}: launches={launches} expected={want}; by "
          f"call shape (K2: causal, Sq, Sk; K4: cache length, head dim) "
          f"{classes} expected {want_classes}; prefill "
          f"{t_prefill * 1e3:.3f} ms, mean decode step "
          f"{t_decode * 1e3:.3f} ms, peak_mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | "
          f"{card_line()}", flush=True)
    if launches != want or classes != want_classes:
        fail(f"{arch}: kernel launch counts differ from what the path "
             "implies")
    if not torch.isfinite(first).all() or not torch.isfinite(logits).all():
        fail(f"{arch}: logits not finite")
    if not bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()):
        fail(f"{arch}: tokens outside the vocabulary")
    longer = torch.cat([toks, out[0][:, None]], 1)
    full, _ = model.prefill(params, longer, cache_len + 1, **feats)
    a, b = first.float(), full[:, -1].float()
    err = (a - b).abs()
    used = float((err / (0.3 + 0.15 * b.abs())).max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f"[families] {arch} consistency: the first decode step's logits "
          f"against a prefill over the prompt and its token: max_abs "
          f"{float(err.max()):.3e}, worst err/tol {used:.3f} (atol 0.3 + "
          f"rtol 0.15), argmax agreement {agree:.2f}", flush=True)
    if used > 1.0:
        fail(f"{arch}: decode disagrees with prefill")
    del params, cache, logits, full
    gc.collect()
    torch.cuda.empty_cache()
    return {k: n for k, n in launches.items() if want[k]}, classes


def parity_families_reduced(torch):
    """Phase 17: reduced qwen2-moe-a2.7b and dbrx-132b on the dense backend
    (:func:`parity_dense_reduced`), reduced phi-3-vision-4.2b with image
    embeddings and whisper-base with frame features through
    ``Model.prefill`` and 8 greedy decode steps, each with the same
    weights and inputs on the card and on the CPU; greedy tokens equal
    under the ``TIE_GAP`` rule (the CPU run's top-2 gaps)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models.model import Model, init_params
    from repro_torch.models.transformer import ImplConfig
    t_phase = time.perf_counter()
    parity_dense_reduced(torch, ("qwen2-moe-a2.7b", "dbrx-132b"))
    for arch in ("phi-3-vision-4.2b", "whisper-base"):
        cfg = reduced_config(get_config(arch))
        params = init_params(cfg, seed=0, device="cpu")
        model = Model(cfg, ImplConfig(remat="none"))
        rng = np.random.default_rng(3)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 40)))
        shape = ((3, cfg.encoder_seq_len, cfg.d_model) if cfg.is_encdec
                 else (3, cfg.num_image_tokens, 1024))
        feats = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
        key = "enc_feats" if cfg.is_encdec else "img_feats"
        pos = toks.shape[1] + cfg.num_image_tokens

        def run(device):
            p = _tree_to(params, device)
            logits, cache = model.prefill(p, toks.to(device), 64,
                                          **{key: feats.to(device)})
            seq = [logits[:, -1].cpu()]
            for i in range(8):
                nxt = seq[-1].argmax(-1)[:, None].to(device)
                logits, cache = model.decode_step(p, nxt, cache, pos + i)
                seq.append(logits[:, -1].cpu())
            rows = torch.stack(seq, 1).float()             # (lanes, 9, V)
            top = rows.topk(2, dim=-1).values
            gaps = (top[..., 0] - top[..., 1]).tolist()
            toks_out = rows.argmax(-1).tolist()
            return ({f"l{i}": t for i, t in enumerate(toks_out)},
                    {f"l{i}": g for i, g in enumerate(gaps)})

        cuda_toks, _ = run("cuda")
        cpu_toks, margins = run("cpu")
        flips = check_parity(cpu_toks, cuda_toks, margins, TIE_GAP)
        print(f"[parity] reduced {arch} with {key} cuda vs cpu: 3 lanes x 9 "
              f"tokens, near-tie flips={flips}, min gap "
              f"{min(min(m) for m in margins.values()):.3e}", flush=True)
    print(f"[parity] phase 17: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 10: the §9.3 loop on the card -- a second submission sized from
# the first one's history
# ---------------------------------------------------------------------------

def history_loop(torch):
    """Full-width tinyllama-1.1b paged serving (8 requests, prompts
    64..1024 from seed 0, 32 new tokens) submitted twice under one app
    name to one ``Cluster`` whose ``HistoryStore`` lives in a fresh
    temporary directory: run, release, submit again, run the same
    requests.  Fails unless the greedy tokens are equal, the history
    holds the first run's observations, and the second submission and
    its pool were sized by ``policy="history"`` over that non-empty
    history; each run's launch counts are what the path implies."""
    import gc
    import tempfile
    import numpy as np
    from repro_torch.core.history import HistoryStore
    from repro_torch.core.materializer import H100
    from repro_torch.core.sizing import solve_init_step
    from repro_torch.launch.serve import DENSE_CACHE_LEN, serve_shape
    from repro_torch.runtime import (Application, Cluster, ServeOptions,
                                     TorchExecutor)
    from repro_torch.runtime.cluster import SIZING_QUANTUM
    from repro_torch.serving.kv_cache import Request
    kernels = _paged_kernels()
    rng = np.random.default_rng(0)
    lens = [int(rng.integers(64, 1025)) for _ in range(8)]
    with tempfile.TemporaryDirectory() as tmp:
        hist = HistoryStore(tmp)
        cluster = Cluster(pods=1, mesh=H100, history=hist,
                          executor=TorchExecutor(device="cuda", seed=0))
        opts = ServeOptions(backend="paged", max_batch=8, pool_pages=128,
                            cache_len=DENSE_CACHE_LEN, private_pool=True)
        runs = []
        for rnd in range(2):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            job = hist.get("tinyllama-1.1b:serve", "job", "bytes")
            job_seen = job.samples() if job else []
            job_last = job.last if job else None
            app = Application.serve(
                "tinyllama-1.1b", shape=serve_shape("paged", 8, 128),
                serve=opts)
            sized = cluster.size(app)[0]
            h = cluster.submit(app)
            placed = h.job.demand_bytes
            name, pool = h.app.name, h.engine.pool
            seen = hist.get(name, "request", "pages")
            seen = (seen.count, seen.samples()) if seen else (0, [])
            sz = pool.sizing()
            for fn in kernels.values():
                fn.launches = 0
            reqs = [Request(f"h{i}", n, 32) for i, n in enumerate(lens)]
            for r in reqs:
                h.submit_request(r)
            h.run()
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in kernels.items()}
            want = _expected_paged(h.runner, h.engine.stats)
            if launches != want or not all(launches.values()):
                fail(f"history loop run {rnd + 1}: launches {launches}, "
                     f"expected {want}")
            runs.append({
                "tokens": [r.output_tokens for r in reqs],
                "sizing": h.sizing, "demand": sized, "placed": placed,
                "grant": h.job.demand_bytes,
                "held": cluster.executor.footprint(h),
                "job_seen": job_seen, "job_last": job_last,
                "floor": h.app.structural_floor(), "plan": h.plan,
                "pool_sizing": sz, "seen": seen, "policy": pool.policy,
                "grants": dict(pool.stats),
                "peak": torch.cuda.max_memory_allocated() - base,
                "stats": h.engine.stats})
            h.release()
        hist.save()
        saved = HistoryStore(tmp)
    first, second = runs
    card = card_line()
    sol = second["sizing"]
    print(f"[history] second submission's SizingSolution: init "
          f"{sol.init / 2**30:.3f} GiB step {sol.step / 2**30:.3f} GiB "
          f"feasible={sol.feasible} expected_scaleups="
          f"{sol.expected_scaleups:.4f} (first submission: "
          f"{first['sizing']}) | {card}", flush=True)
    for i, run in enumerate(runs, 1):
        psz, g = run["pool_sizing"], run["grants"]
        print(f"[history] run {i}: demand {run['demand'] / 2**30:.3f} GiB "
              f"(structural floor {run['floor'] / 2**30:.3f} GiB), grant "
              f"{run['placed'] / 2**30:.3f} GiB once bound, "
              f"{run['grant'] / 2**30:.3f} GiB after the run over "
              f"{run['held'] / 2**30:.3f} GiB held, pool "
              f"policy={run['policy']} over {run['seen'][0]} observations: "
              f"init {psz.init:.0f} pages step {psz.step:.0f}, grants "
              f"{g['grants']} of {g['grant_pages']} pages, scaleups "
              f"{g['scaleups']}, mean_ttft "
              f"{run['stats'].mean_ttft_s * 1e3:.3f} ms mean_decode_step "
              f"{run['stats'].mean_decode_step_s * 1e3:.3f} ms, peak "
              f"memory {run['peak'] / 2**30:.3f} GiB over what was "
              f"allocated before the submission | {card}", flush=True)
    print(f"[history] plan: {second['plan'].describe()}", flush=True)
    h_pages = saved.get(name, "request", "pages")
    h_job = saved.get(name, "job", "bytes")
    if second["tokens"] != first["tokens"] or not all(
            len(t or []) == 33 for t in first["tokens"]):
        fail("history loop: the second run's greedy tokens differ from "
             "the first's")
    # one page observation a release (completion or preemption), one job
    # observation a finished submission
    releases = [8 + run["stats"].preempted for run in runs]
    if not (h_pages and h_pages.count == sum(releases) and h_job
            and h_job.count == 2 and second["seen"][0] == releases[0]):
        fail(f"history loop: the history does not hold the runs' "
             f"observations ({h_pages}, {h_job}, second saw "
             f"{second['seen'][0]})")
    want_pool = solve_init_step(second["seen"][1], quantum=1.0)
    want_job = solve_init_step(second["job_seen"],
                               quantum=float(SIZING_QUANTUM))
    if not (first["sizing"] is None and sol is not None and sol.feasible
            and second["job_seen"] and sol == want_job
            and second["demand"] == max(int(sol.init), second["floor"])
            and second["policy"] == "history" and second["seen"][1]
            and (second["pool_sizing"].init, second["pool_sizing"].step)
            == (want_pool.init, want_pool.step)):
        fail("history loop: the second submission was not sized by "
             "policy='history' over the first run's history")
    # the scheduler accounts what the app held on the card: each run's
    # grant covers its measured peak, and the history the second
    # submission was sized from holds the first run's
    if not all(run["grant"] >= run["held"] >= run["peak"] for run in runs):
        fail(f"history loop: a grant is below the measured peak "
             f"{[(r['grant'], r['held'], r['peak']) for r in runs]}")
    if not second["job_last"] == first["grant"] >= first["peak"]:
        fail(f"history loop: the history's last job observation "
             f"{second['job_last']} is not the first run's grant "
             f"{first['grant']} over its peak {first['peak']}")


# ---------------------------------------------------------------------------
# phase 11: full-width gemma3-12b -- ring pages on the paged backend, the
# ring cache on the dense one, and the pure-global configs' plans
# ---------------------------------------------------------------------------

GEMMA3_POOL_PAGES = 192          # 48 MiB a page over the 48 layers: 9 GiB


@contextmanager
def ring_watch():
    """At every paged decode step: the ring pages the pool holds and the
    requests running, which must hold at most ``ring_pages`` each.
    Yields {"peak": ring pages, "running": requests then, "ring": ring
    pages a request, "steps": steps seen}."""
    from repro_torch.serving.model_runner import PagedRunner
    plain, seen = PagedRunner.decode, {"peak": 0, "running": 0, "ring": 0,
                                       "steps": 0}

    def decode(self, running):
        pool = self.engine.pool
        ring = self.groups.ring_pages
        if pool.used_local > ring * len(running):
            fail(f"rings: {pool.used_local} ring pages held by "
                 f"{len(running)} requests of {ring} at most")
        if pool.used_local > seen["peak"]:
            seen.update(peak=pool.used_local, running=len(running))
        seen.update(ring=ring, steps=seen["steps"] + 1)
        return plain(self, running)

    PagedRunner.decode = decode
    try:
        yield seen
    finally:
        PagedRunner.decode = plain


def serve_gemma3_full(torch):
    """(a) full-width gemma3-12b (random bf16 weights from seed 0) serves 8
    requests, prompts 64..2048 tokens from seed 0 (two past 1152, so
    their rings wrap at prefill), 32 new tokens, max batch 8, through
    ``launch.serve`` (``Cluster.submit`` on the paged backend, ring pages
    on 40 of 48 layers, a pool of ``GEMMA3_POOL_PAGES``); every request
    completes, launch counts equal what the path implies, the ring pages
    held never pass ``ring_pages`` a running request; TTFT, decode step,
    peak memory against the plan's estimate.  Then the same serve with 8
    new tokens on the same weights under ``torch.profiler`` (busy
    share).  (b) those weights on ``PagedRunner`` and ``DenseRunner``: 2
    requests of 1500-token prompts, 80 new tokens, greedy tokens equal
    under the ``TIE_GAP`` rule.  (c) the ladder's plans of full-width
    mistral-nemo-12b and command-r-35b on the card's mesh (host
    arithmetic).  Returns the launches of (a) and (b) by kernel name."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import TorchExecutor
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    kernels = _dense_kernels()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with row_copies() as seen, ring_watch() as rings:
        out = serve_gemma3(max_new=32)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in kernels.items()}
    no_row_copies("gemma3 serve", seen)
    stats, runner, reqs = out["stats"], out["runner"], out["requests"]
    cfg = runner.cfg
    for r in reqs:
        toks = r.output_tokens or []
        if len(toks) != 33 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"gemma3 serve: {r.req_id} returned {len(toks)} tokens "
                 f"(expected 1 + 32 in [0, {cfg.vocab_size}))")
    lens = [r.prompt_len for r in reqs]
    ring_tokens = runner.groups.ring_pages * 128
    if sum(n > ring_tokens for n in lens) < 2:
        fail(f"gemma3 serve: prompts {lens}: fewer than two wrap the ring "
             f"of {ring_tokens} tokens")
    if not runner.use_rings or out["pool"].groups is None:
        fail("gemma3 serve: the paged runner did not serve from ring pages")
    want = dict(_expected_paged(runner, stats), decode_attention=0,
                ssd_scan=0, rwkv6_wkv=0)
    print(f"[gemma3] full width, prompts {lens}, prefills={stats.prefills} "
          f"chunks={runner.prefill_chunks} decode_steps="
          f"{stats.decode_steps} launches={launches} expected={want}",
          flush=True)
    if launches != want:
        fail("gemma3 serve: kernel launch counts differ from what the path "
             "implies")
    norms = _norms_per_layer(cfg) * cfg.num_layers
    RMS_LAUNCHES["prefill"] += norms * runner.prefill_chunks + stats.prefills
    RMS_LAUNCHES["decode"] += (norms + 1) * stats.decode_steps
    plan = out["plan"]
    print(f"[gemma3] mean_ttft={stats.mean_ttft_s * 1e3:.3f} ms "
          f"mean_decode_step={stats.mean_decode_step_s * 1e3:.3f} ms "
          f"tokens/s={stats.tokens_generated / stats.wall_s:.2f} "
          f"wall={wall:.3f} s; peak_mem {peak / 2**30:.3f} GiB against the "
          f"plan's est_bytes_per_device "
          f"{plan.est_bytes_per_device / 2**30:.3f} GiB ({plan.shape}, "
          f"{plan.notes})", flush=True)
    print(f"[gemma3] ring pages: peak pool_used_local_pages={rings['peak']} "
          f"with {rings['running']} running (at most {rings['ring']} x "
          f"{rings['running']} = {rings['ring'] * rings['running']}), over "
          f"{rings['steps']} decode steps", flush=True)
    params = runner.params
    del out, runner, reqs
    gc.collect()
    torch.cuda.empty_cache()

    class Held(TorchExecutor):
        """Binds the weights already on the card, so that the profiled
        window holds the serve and not their making."""

        def init_params(self, handle):
            return params

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        stats = serve_gemma3(8, Held(device="cuda", seed=0))["stats"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, f"gemma3-12b serve 8 req x 8 new on the same "
                               f"weights (decode_steps {stats.decode_steps},"
                               f" prefills {stats.prefills})")
    del prof
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in parity_gemma3_full(torch, cfg, params).items():
        launches[name] += n
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print_pure_global_plans()
    print(f"[gemma3] phase 11: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def serve_gemma3(max_new, executor=None):
    """Phase 11 (a)'s traffic through ``launch.serve``: 8 requests, prompts
    64..2048 tokens from seed 0, ``max_new`` new tokens, max batch 8,
    ``GEMMA3_POOL_PAGES``; bound by ``executor`` when one is given."""
    from repro_torch.launch.serve import serve
    return serve("gemma3-12b", device="cuda", requests=8, max_batch=8,
                 pool_pages=GEMMA3_POOL_PAGES, prompt_range=(64, 2048),
                 max_new=max_new, seed=0, executor=executor)


def parity_gemma3_full(torch, cfg, params):
    """Phase 11 (b): paged (ring pages) against dense (ring cache) at full
    width on the same weights: 2 requests of 1500-token prompts from seed
    0 (equal lengths: the dense path decodes at one shared position), 80
    new tokens; equal tokens under the ``TIE_GAP`` rule, the dense run's
    margins deciding.  Returns both runs' launches by kernel name, each
    run's checked against what its path implies."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PageGroups, PagePool, Request
    from repro_torch.serving.model_runner import DenseRunner, PagedRunner
    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 1500))
               for _ in range(2)]
    kernels = _dense_kernels()
    total = {name: 0 for name in kernels}
    toks, margins = {}, {}
    for backend in ("paged", "dense"):
        if backend == "paged":
            runner = PagedRunner(cfg, pool_pages=32, max_batch=2,
                                 params=params, device="cuda",
                                 record_margins=True)
            pool = PagePool(32, policy="fixed",
                            groups=PageGroups.from_config(cfg))
        else:
            runner = DenseRunner(cfg, max_batch=2, cache_len=2048,
                                 params=params, device="cuda",
                                 record_margins=True)
            pool = PagePool(32, policy="fixed")
        eng = ServingEngine(pool, max_batch=2, runner=runner)
        reqs = [Request(f"q{i}", len(p), 80, prompt_tokens=p)
                for i, p in enumerate(prompts)]
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        st = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: fn.launches for name, fn in kernels.items()}
        if backend == "paged":
            want = dict(_expected_paged(runner, st), decode_attention=0,
                        ssd_scan=0, rwkv6_wkv=0)
        else:
            want = _expected_dense(cfg, st.prefills, st.decode_steps)
        print(f"[gemma3 parity] {backend}: decode_steps={st.decode_steps} "
              f"mean_ttft={st.mean_ttft_s * 1e3:.3f} ms mean_decode_step="
              f"{st.mean_decode_step_s * 1e3:.3f} ms wall={wall:.3f} s "
              f"launches={got} expected={want}", flush=True)
        if got != want:
            fail(f"gemma3 parity: {backend} launch counts differ from what "
                 "the path implies")
        for name, n in got.items():
            total[name] += n
        norms = _norms_per_layer(cfg) * cfg.num_layers
        RMS_LAUNCHES["prefill"] += (norms + 1) * st.prefills
        RMS_LAUNCHES["decode"] += (norms + 1) * st.decode_steps
        toks[backend] = {r.req_id: r.output_tokens for r in reqs}
        margins[backend] = runner.margins
        del runner, eng
        torch.cuda.empty_cache()
    flips = check_parity(toks["dense"], toks["paged"], margins["dense"],
                         TIE_GAP)
    print(f"[gemma3 parity] paged (rings) vs dense (ring cache), 2 x 1500 "
          f"tokens + 80 new: near-tie flips={flips}, min gap "
          f"{min(min(m) for m in margins['dense'].values()):.3e}",
          flush=True)
    return total


def print_pure_global_plans():
    """Phase 11 (c): the ladder's plan on the card's mesh for full-width
    mistral-nemo-12b and command-r-35b at phase 11's serve shape, host
    arithmetic only, with the parameter count and its bf16 bytes."""
    from repro_torch.configs import get_config
    from repro_torch.core.materializer import H100, materialize
    from repro_torch.core.profiles import model_param_count
    from repro_torch.launch.serve import serve_shape
    shape = serve_shape("paged", 8, GEMMA3_POOL_PAGES)
    for arch in ("mistral-nemo-12b", "command-r-35b"):
        cfg = get_config(arch)
        plan = materialize(cfg, shape, H100)
        n = model_param_count(cfg)
        print(f"[plans] {arch} full width at {shape.name} on {H100.name}: "
              f"{n / 1e9:.3f} B parameters ({2 * n / 1e9:.2f} GB bf16), "
              f"est_bytes_per_device {plan.est_bytes_per_device / 2**30:.3f} "
              f"GiB, remat={plan.remat} fsdp={plan.fsdp} tp={plan.tp} "
              f"({plan.notes})", flush=True)


# ---------------------------------------------------------------------------
# phase 12: full-width mistral-nemo-12b on the pod's shared KV memory --
# the prefix cache warm against cold, eviction under co-tenant pressure,
# and replica migration on one aliased store
# ---------------------------------------------------------------------------

MISTRAL_POOL_PAGES = 192         # 20 MiB a page over the 40 layers: 3.77 GiB
MISTRAL_SHARED_PREFIX = 1500     # 11 full pages and 92 tokens: a COW lead
MISTRAL_PRESSURE_PAGES = 48
LEAK_BYTES = 64 << 20


def _mistral_executor(params, margins=True, kv_watch=None):
    """A ``TorchExecutor`` that binds mistral-nemo-12b with ``params``
    (made once on the card) and any other config with random weights
    from seed 0; with ``margins`` each runner records its top-2 logit
    gaps (the ``TIE_GAP`` rule's evidence); with ``kv_watch`` (a dict)
    each mistral prefill is followed by :func:`_watch_prefix_kv`."""
    from repro_torch.runtime import TorchExecutor

    class Held(TorchExecutor):
        def init_params(self, handle):
            if handle.app.config.name == "mistral-nemo-12b":
                return params
            return super().init_params(handle)

        def build_replica(self, handle, idx):
            rep = super().build_replica(handle, idx)
            if margins:
                rep.runner.margins = {}
            if kv_watch is not None and handle.app.config.name == \
                    "mistral-nemo-12b":
                plain, runner = rep.runner.prefill, rep.runner

                def prefill(req):
                    plain(req)
                    _watch_prefix_kv(runner, req, kv_watch)

                rep.engine.step_fns = (prefill, rep.engine.step_fns[1])
            return rep

    return Held(device="cuda", seed=0)


def _watch_prefix_kv(runner, req, watch):
    """Right after ``req``'s prefill: its K and V at the shared system
    prompt's positions ``[0, MISTRAL_SHARED_PREFIX)``, read through its
    own table (the cache's pages and its private copy-on-write lead when
    warm, its own pages when cold), on the first, middle and last layer,
    against the first watched request's, elementwise on the device (one
    flag a request; nothing waits here).  Those positions' tokens are the
    same in every request, and the computation that produced them is the
    same row for row (chunks on the same grid), so they must be BIT-equal:
    a wrong page, a wrong lead or a stale cache page would not be."""
    import torch
    n = MISTRAL_SHARED_PREFIX
    table = list(req.shared_pages) + runner._phys(req.pages)
    pages = runner._ids(table[:-(-n // 128)])
    layers = (0, runner.num_layers // 2, runner.num_layers - 1)
    got = [t[layer][pages].flatten(0, 1)[:n]
           for layer in layers
           for t in (runner.store.k_pages, runner.store.v_pages)]
    if "ref" not in watch:
        watch["ref"] = [g.clone() for g in got]
        watch["flags"] = []
    same = torch.stack([(g.view(torch.int16) == r.view(torch.int16)).all()
                        for g, r in zip(got, watch["ref"])])
    watch["flags"].append((req.req_id, same.all()))


def _mistral_requests(vocab, max_new=32):
    """Phase 12's traffic: 8 prompts of one shared 1500-token system
    prompt and each its own 64..512-token suffix (seed 0), ``max_new``
    new tokens."""
    from repro_torch.launch.serve import synth_requests
    return synth_requests(8, vocab, prompt_range=(
        MISTRAL_SHARED_PREFIX + 64, MISTRAL_SHARED_PREFIX + 512),
        max_new=max_new, seed=0, shared_prefix=MISTRAL_SHARED_PREFIX)


def _sum_launches(*dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def _mistral_run(torch, params, *, prefix_cache, max_new=32, replicas=1,
                 drain_after=None, margins=True, kv_watch=None,
                 chunk_pages=4):
    """One serve of phase 12's traffic through ``launch.serve``'s
    ``submit_app`` (``Cluster.submit`` -> the ``TorchExecutor`` on a view
    of the pod's shared pool of ``MISTRAL_POOL_PAGES``, ``chunk_pages``
    4 unless given, max batch 8): request 0 alone, then the other 7
    together; with ``drain_after`` the highest replica is removed after
    that many steps of the 7.  Checks the launch counts against what the
    path implies and that the release returns the store's bytes.  Returns
    what it saw."""
    import types
    from repro_torch.configs import get_config
    from repro_torch.core.history import HistoryStore
    from repro_torch.core.materializer import H100
    from repro_torch.launch.serve import submit_app
    from repro_torch.runtime import Cluster
    kernels = _paged_kernels()
    cluster = Cluster(pods=1, mesh=H100, history=HistoryStore(),
                      executor=_mistral_executor(params, margins, kv_watch))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    h = submit_app(cluster, "mistral-nemo-12b", max_batch=8,
                   pool_pages=MISTRAL_POOL_PAGES, prefix_cache=prefix_cache,
                   replicas=replicas, chunk_pages=chunk_pages)
    reps = list(h.replica_set.replicas)
    runners = [r.runner for r in reps]
    store = runners[0].store
    shared = cluster.pod_pool("pod0")
    if replicas > 1 and not (
            len({id(r.store) for r in runners}) == 1
            and len({id(r.params["embed"]["tok"]) for r in runners}) == 1
            and shared.kv_device_bytes() == store.device_bytes()):
        fail("mistral: replicas do not alias one store and one set of "
             "weights")
    reqs = _mistral_requests(get_config("mistral-nemo-12b").vocab_size,
                             max_new)
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    h.submit_request(reqs[0])
    h.run()
    for r in reqs[1:]:
        h.submit_request(r)
    receipt = None
    if drain_after is not None:
        for _ in range(drain_after):
            h.step()
        receipt = h.remove_replica()
    h.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    view = h.stats_view.cumulative()
    stats = types.SimpleNamespace(prefills=view["prefills"],
                                  decode_steps=view["decode_steps"])
    want = _expected_paged(types.SimpleNamespace(
        cfg=runners[0].cfg,
        prefill_chunks=sum(r.prefill_chunks for r in runners)), stats)
    if launches != want or not all(launches.values()):
        fail(f"mistral serve: launches {launches}, expected {want}")
    out = {"tokens": {r.req_id: r.output_tokens for r in reqs},
           "margins": _sum_margins(runners), "view": view,
           "rms_decode": ((_norms_per_layer(runners[0].cfg)
                           * runners[0].cfg.num_layers + 1)
                          * view["decode_steps"]),
           "launches": launches, "wall": wall, "receipt": receipt,
           "ttft0": reqs[0].first_token_at - reqs[0].submitted_at,
           "ttft7": sum(r.first_token_at - r.submitted_at
                        for r in reqs[1:]) / 7,
           "lens": [r.prompt_len for r in reqs], "plan": h.plan,
           "store_bytes": store.device_bytes(),
           "footprint": cluster.executor.footprint(h),
           "peak": torch.cuda.max_memory_allocated() - base}
    for r in reqs:
        toks = r.output_tokens or []
        if len(toks) != 1 + max_new or not all(
                0 <= t < runners[0].cfg.vocab_size for t in toks):
            fail(f"mistral serve: {r.req_id} returned {len(toks)} tokens")
    h.release()
    torch.cuda.synchronize()
    out["after"] = torch.cuda.memory_allocated() - base
    if out["after"] > LEAK_BYTES or store.device_bytes():
        fail(f"mistral serve: {out['after'] / 2**20:.1f} MiB still held "
             f"after the release (store {store.device_bytes()} bytes)")
    return out


def _sum_margins(runners):
    out = {}
    for r in runners:
        for rid, gaps in (r.margins or {}).items():
            out.setdefault(rid, []).extend(gaps)
    return out


def _pressure_run(torch, params, pressure, kv_watch):
    """(c): a pod pool of ``MISTRAL_PRESSURE_PAGES``.  The prefix-cached
    mistral app serves requests 0 and 1 one after the other (their pages
    stay cached, refcount 0), then request 2 is pinned, prefilled and
    decodes through its 12 pinned prefix pages while, with ``pressure``,
    a full-width tinyllama-1.1b co-tenant (another KV shape, so another
    store) submits 3 requests at once whose demand overshoots the free
    list, though any one of them fits: the pool must evict refcount-0
    cache pages and never a pinned one.  Returns request 2's tokens and
    margins, the evictions, and the launches checked against both apps'
    paths."""
    from repro_torch.configs import get_config
    from repro_torch.core.history import HistoryStore
    from repro_torch.core.materializer import H100
    from repro_torch.launch.serve import submit_app
    from repro_torch.runtime import Cluster
    from repro_torch.serving.kv_cache import Request
    kernels = _paged_kernels()
    cluster = Cluster(pods=1, mesh=H100, history=HistoryStore(),
                      executor=_mistral_executor(params,
                                                 kv_watch=kv_watch),
                      pool_pages=MISTRAL_PRESSURE_PAGES)
    a = submit_app(cluster, "mistral-nemo-12b", max_batch=8,
                   pool_pages=MISTRAL_PRESSURE_PAGES, prefix_cache=True,
                   name="cached-a")
    shared = cluster.pod_pool("pod0")
    reqs = _mistral_requests(get_config("mistral-nemo-12b").vocab_size)
    for fn in kernels.values():
        fn.launches = 0
    for r in reqs[:2]:
        a.submit_request(r)
        a.run()
    ra = reqs[2]
    a.submit_request(ra)
    a.step()                               # pin + prefill, mid-decode
    out = {"evicted": 0, "cached": a.runner.prefix.num_pages,
           "pinned": sum(1 for n in a.runner.prefix.nodes if n.refs),
           "free": len(shared.free)}
    apps = [a]
    if pressure:
        b = submit_app(cluster, "tinyllama-1.1b", max_batch=8,
                       pool_pages=MISTRAL_PRESSURE_PAGES, policy="fixed",
                       name="greedy-b")
        apps.append(b)
        k = out["free"] // 3 + 2               # 3k > free; k alone fits
        out["co_tenant_pages"] = k
        if not (3 * k > out["free"]
                and k <= shared.num_pages - out["pinned"]
                - len(a.engine.running[0].pages)):
            fail(f"pressure: {k} pages a request cannot both overshoot "
                 f"{out['free']} free pages and fit alone")
        for i in range(3):
            b.submit_request(Request(f"big{i}", k * 128 - 10, 4))
        while b.step()["alive"]:
            pass
        out["co_tenant_done"] = b.engine.stats.completed
        out["evicted"] = shared.stats["prefix_evictions"]
    a.run()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    want = _sum_launches(*(_expected_paged(h.runner, h.engine.stats)
                           for h in apps))
    out["mistral_launches"] = _expected_paged(a.runner, a.engine.stats)
    out["rms_decode"] = sum(
        (_norms_per_layer(h.runner.cfg) * h.runner.cfg.num_layers + 1)
        * h.engine.stats.decode_steps for h in apps)
    if launches != want:
        fail(f"pressure: launches {launches}, expected {want}")
    out.update(tokens={ra.req_id: ra.output_tokens},
               margins={ra.req_id: a.runner.margins[ra.req_id]},
               launches=launches)
    for h in apps[::-1]:
        h.release()
    return out


def _parting(ref, run):
    """Where each request's greedy tokens part from ``ref``'s: {req id:
    (step, ref's top-2 logit gap there)} for the requests that part."""
    out = {}
    for rid, want in ref["tokens"].items():
        got = run["tokens"][rid]
        for j, (a, b) in enumerate(zip(want, got)):
            if a != b:
                out[rid] = (j, ref["margins"][rid][j])
                break
    return out


def serve_mistral_full(torch):
    """Phase 12.  Full-width mistral-nemo-12b (40 layers, d 5120, 32/8
    heads of 128, random bf16 weights from seed 0, made once) served
    through ``Cluster.submit`` on the pod's shared page pool: (a) cold,
    no prefix cache; (b) warm, the prefix cache on: hit rate 7/8, at least
    one copy-on-write, fewer prefill pages; then (b)'s traffic with 8 new
    tokens under ``torch.profiler`` (busy share); (c) eviction under a
    tinyllama-1.1b co-tenant's pressure, request 2's tokens equal to a
    calm run's; (d) 2 replicas on one aliased store, replica 1 drained
    mid-decode, its requests migrated with none requeued and tokens equal
    to (b)'s.  Every mistral prefill of (a)-(d) must leave the shared
    prompt's K and V bit-equal to the first one's (``_watch_prefix_kv``).
    Warm against cold tokens are printed, not gated: they part where the
    prefill's chunks hold other rows (cuBLAS rounds those GEMMs
    otherwise), and so does a cold run at ``chunk_pages=2`` (the control,
    also printed), by more than ``TIE_GAP`` at this width.  Every release
    returns the store's bytes, and no run's peak passes (a)'s by more
    than 1 GiB.  Returns the launches by kernel name, the ``*_d128``
    entries counting mistral's only."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    cfg = get_config("mistral-nemo-12b")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    print(f"[mistral] weights made on the card in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated",
          flush=True)
    launches, d128, watch = {}, {}, {}

    def count(run, mistral=None):
        run_launches = run["launches"]
        for k, v in run_launches.items():
            launches[k] = launches.get(k, 0) + v
        RMS_LAUNCHES["decode"] += run["rms_decode"]
        RMS_LAUNCHES["prefill"] += run_launches["rmsnorm"] - run["rms_decode"]
        for k, v in (mistral or run_launches).items():
            if k != "rmsnorm":
                d128[f"{k}_d128"] = d128.get(f"{k}_d128", 0) + v

    cold = _mistral_run(torch, params, prefix_cache=False, kv_watch=watch)
    count(cold)
    cold_peak = cold["peak"]
    control = _mistral_run(torch, params, prefix_cache=False, chunk_pages=2)
    count(control)
    warm = _mistral_run(torch, params, prefix_cache=True, kv_watch=watch)
    count(warm)
    for label, run in (("cold", cold), ("cold, chunk_pages=2", control),
                       ("warm", warm)):
        v = run["view"]
        print(f"[mistral] ({label}) prompts {run['lens']}: TTFT request 0 "
              f"{run['ttft0'] * 1e3:.3f} ms, mean TTFT of the 7 together "
              f"{run['ttft7'] * 1e3:.3f} ms, mean decode step "
              f"{v['mean_decode_step_s'] * 1e3:.3f} ms, prefill pages "
              f"computed {v['prefill_pages_computed']}, prefix hit rate "
              f"{v.get('prefix_hit_rate')}, cow_copies "
              f"{v.get('cow_copies')}, shared_pages {v.get('shared_pages')}, "
              f"launches {run['launches']}, peak "
              f"{run['peak'] / 2**30:.3f} GiB over the weights held "
              f"before (plan est_bytes_per_device "
              f"{run['plan'].est_bytes_per_device / 2**30:.3f} GiB for "
              f"the whole app, {run['plan'].shape}), store "
              f"{run['store_bytes'] / 2**30:.3f} GiB, footprint "
              f"{run['footprint'] / 2**30:.3f} GiB, wall "
              f"{run['wall']:.3f} s | {card}", flush=True)
    wv, cv = warm["view"], cold["view"]
    if not (wv["prefix_hit_rate"] == 7 / 8 and wv["cow_copies"] >= 1
            and wv["prefill_pages_computed"] < cv["prefill_pages_computed"]):
        fail(f"mistral warm: hit rate {wv['prefix_hit_rate']}, cow "
             f"{wv['cow_copies']}, prefill pages "
             f"{wv['prefill_pages_computed']} vs cold "
             f"{cv['prefill_pages_computed']}")
    for label, run in (("warm", warm), ("cold at chunk_pages=2", control)):
        parts = _parting(cold, run)
        print(f"[mistral] {label} vs cold tokens: {8 - len(parts)}/8 "
              f"requests exactly equal; parted (step, cold's top-2 gap): "
              f"{ {k: (j, round(g, 5)) for k, (j, g) in parts.items()} }",
              flush=True)
    print(f"[mistral] prefill pages warm/cold {wv['prefill_pages_computed']}"
          f"/{cv['prefill_pages_computed']} = "
          f"{wv['prefill_pages_computed'] / cv['prefill_pages_computed']:.3f}",
          flush=True)
    del cold, control
    gc.collect()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prof_run = _mistral_run(torch, params, prefix_cache=True, max_new=8,
                                margins=False)
        wall = time.perf_counter() - t0
    report_profile(prof, wall, f"mistral-nemo-12b warm serve 8 req x 8 new "
                               f"(decode_steps "
                               f"{prof_run['view']['decode_steps']}, prefill "
                               f"chunks "
                               f"{prof_run['launches']['flash_attention_fwd'] // cfg.num_layers})")
    del prof, prof_run
    gc.collect()

    calm = _pressure_run(torch, params, False, watch)
    count(calm)
    pressed = _pressure_run(torch, params, True, watch)
    count(pressed, pressed["mistral_launches"])
    print(f"[mistral] (c) pressure: pool {MISTRAL_PRESSURE_PAGES} pages, "
          f"{pressed['cached']} cached of which {pressed['pinned']} pinned, "
          f"{pressed['free']} free; co-tenant 3 x "
          f"{pressed['co_tenant_pages']} pages, completed "
          f"{pressed['co_tenant_done']}; prefix_evictions "
          f"{pressed['evicted']} (calm {calm['evicted']}); request 2's "
          f"tokens equal to the calm run's: "
          f"{calm['tokens'] == pressed['tokens']}", flush=True)
    if pressed["evicted"] <= 0 or pressed["co_tenant_done"] != 3:
        fail("pressure: the co-tenant's demand evicted no cached page")
    if calm["tokens"] != pressed["tokens"]:
        fail("pressure: request 2's tokens changed under eviction")

    mig = _mistral_run(torch, params, prefix_cache=True, replicas=2,
                       drain_after=3, kv_watch=watch)
    count(mig)
    rc = mig["receipt"]
    print(f"[mistral] (d) 2 replicas, one store of "
          f"{mig['store_bytes'] / 2**30:.3f} GiB, footprint "
          f"{mig['footprint'] / 2**30:.3f} GiB (one replica: "
          f"{warm['footprint'] / 2**30:.3f}): drained replica 1 -> {rc}; "
          f"tokens equal to (b)'s: {mig['tokens'] == warm['tokens']}; "
          f"peak {mig['peak'] / 2**30:.3f} GiB | {card}", flush=True)
    if rc["migrated_requests"] < 1 or rc["requeued_requests"] != 0:
        fail(f"migration: receipt {rc}")
    if mig["tokens"] != warm["tokens"]:
        fail("migration: the migrated requests' tokens differ from (b)'s")
    if mig["footprint"] != warm["footprint"]:
        fail("migration: two replicas hold more than one store and one set "
             "of weights")
    flags = [(rid, bool(ok)) for rid, ok in watch["flags"]]   # one wait
    bad = [rid for rid, ok in flags if not ok]
    print(f"[mistral] shared prompt's K/V (layers 0, 20, 39) bit-equal to "
          f"the first prefill's in {len(flags) - len(bad)} of {len(flags)} "
          f"prefills of (a)-(d)", flush=True)
    if bad:
        fail(f"mistral: the shared prompt's K/V differs in {bad}")
    # a store left behind by a release would add its 3.77 GiB here
    for label, run in (("warm", warm), ("migration", mig)):
        if run["peak"] > cold_peak + (1 << 30):
            fail(f"mistral {label}: peak {run['peak']} grew past the cold "
                 f"run's {cold_peak} by more than 1 GiB")
    print(f"[mistral] peaks over the weights: cold "
          f"{cold_peak / 2**30:.3f}, warm {warm['peak'] / 2**30:.3f}, "
          f"migration {mig['peak'] / 2**30:.3f} GiB; bytes held after "
          f"each release <= {LEAK_BYTES >> 20} MiB", flush=True)
    del params, warm, mig, watch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mistral] phase 12: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, d128


# ---------------------------------------------------------------------------
# phase 13: idle parking and the autoscale control plane -- two aliased
# tinyllama-1.1b tenants parked and unparked, the launcher's --autoscale
# path, a dense zamba2-2.7b park, a reduced gemma3-12b ring park
# ---------------------------------------------------------------------------

PARK_POOL_PAGES = 128
PARK_SHARED_PREFIX = 256         # a's prompts share their first 2 pages
PARK_MAX_NEW = 64
PARK_SLACK = 1 << 20             # 1 MiB: each byte gate's tolerance


def _requested(torch) -> int:
    """The bytes the live tensors on the card asked the allocator for.
    ``memory_allocated`` counts each block as the allocator cut it (a
    large block keeps its segment's tail when that is at most 1 MiB), so
    the same tensors made again after an ``empty_cache`` can read up to
    1 MiB apart a tensor; the requested bytes are exact."""
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def _tree_bytes(tree) -> int:
    from repro_torch.runtime.executors import _tensor_bytes
    return _tensor_bytes([tree])


def _host_bytes(tree) -> int:
    """Bytes of the host arrays in a park snapshot (or a part of one)."""
    import numpy as np
    n, stack = 0, [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, np.ndarray):
            n += x.nbytes
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return n


def _margin_executor():
    """A ``TorchExecutor`` on the card (random weights from seed 0) whose
    runners record their top-2 logit gaps (the ``TIE_GAP`` rule's
    evidence)."""
    from repro_torch.runtime import TorchExecutor

    class Margins(TorchExecutor):
        def build_replica(self, handle, idx):
            rep = super().build_replica(handle, idx)
            rep.runner.margins = {}
            return rep

    return Margins(device="cuda", seed=0)


class _Parker:
    """Parks and unparks handles on the card, timing each call, checking
    its receipt and the allocator's bytes, and keeping what moved."""

    def __init__(self, torch):
        self.torch = torch
        self.moves = []          # (label, wall s, host bytes, bytes freed)
        self.receipts = []

    def park(self, h, label, *, drop, drained):
        """Park ``h``: its receipt frees the job's bytes and drains
        ``drained`` requests, and the requested bytes fall by at least
        ``drop`` (bytes summed from the tensors that must go) less 1 MiB.
        Returns the requested bytes before the park."""
        torch = self.torch
        demand = h.job.demand_bytes
        before = _requested(torch)
        t0 = time.perf_counter()
        receipt = h.park()
        wall = time.perf_counter() - t0
        fell = before - _requested(torch)
        moved = _host_bytes(h.exec_state["parked"].runner_state)
        self.moves.append((f"{label} park", wall, moved, fell))
        self.receipts.append((f"{label} park", receipt))
        if receipt["freed_bytes"] != demand:
            fail(f"park {label}: freed {receipt['freed_bytes']} bytes, the "
                 f"job held {demand}")
        if receipt["drained_requests"] != drained:
            fail(f"park {label}: receipt {receipt}, {drained} to drain")
        if fell < drop - PARK_SLACK:
            fail(f"park {label}: requested bytes fell by {fell}, less than "
                 f"{drop} - 1 MiB")
        if h.runner.params is not None:
            fail(f"park {label}: the runner still holds its weights")
        return before

    def unpark(self, h, label, *, restored, requeued, call=None):
        """Unpark ``h`` (through ``call``: a ``submit_request`` unparks
        transparently) and check the receipt's counts."""
        from repro_torch.runtime.cluster import AppHandle
        st = h.exec_state["parked"].runner_state
        got = []

        def unpark():
            t0 = time.perf_counter()
            got.append(AppHandle.unpark(h))
            self.torch.cuda.synchronize()
            got.append(time.perf_counter() - t0)
            return got[0]

        h.unpark = unpark
        try:
            (call or h.unpark)()
        finally:
            del h.unpark
        receipt, wall = got
        self.moves.append((f"{label} unpark", wall, _host_bytes(st), None))
        self.receipts.append((f"{label} unpark", receipt))
        if (receipt["restored_requests"], receipt["requeued_requests"]) != (
                restored, requeued):
            fail(f"unpark {label}: receipt {receipt}, expected {restored} "
                 f"restored and {requeued} requeued")
        if receipt["reacquired_bytes"] != h.job.demand_bytes:
            fail(f"unpark {label}: reacquired {receipt['reacquired_bytes']},"
                 f" the job holds {h.job.demand_bytes}")
        return receipt

    def back(self, before, label):
        now = _requested(self.torch)
        if abs(now - before) > PARK_SLACK:
            fail(f"{label}: {now} bytes requested after the unpark, "
                 f"{before} before the park")


def _park_requests(vocab):
    """(a)'s traffic: phase 3's prompt lengths (seed 0), the first four to
    a, whose prompts share their first ``PARK_SHARED_PREFIX`` tokens, the
    last four to b; ``PARK_MAX_NEW`` new tokens; plus a's one more
    request of 16 tokens and 8 new.  Explicit tokens from numpy, seed 0."""
    import numpy as np
    from repro_torch.launch.serve import synth_requests
    from repro_torch.serving.kv_cache import Request
    lens = [r.prompt_len for r in synth_requests(
        8, vocab, prompt_range=(64, 1024), seed=0)]
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, PARK_SHARED_PREFIX).tolist()

    def toks(n, shared):
        own = rng.integers(0, vocab, n - len(shared)).tolist()
        return tuple(shared + own)

    ra = [Request(f"a{i}", n, PARK_MAX_NEW, prompt_tokens=toks(n, prefix))
          for i, n in enumerate(lens[:4])]
    rb = [Request(f"b{i}", n, PARK_MAX_NEW, prompt_tokens=toks(n, []))
          for i, n in enumerate(lens[4:])]
    extra = Request("a-extra", 16, 8, prompt_tokens=toks(16, []))
    return ra, rb, extra


def _count_paged(runners, views, launches):
    """Check ``launches`` against what the paged path implies for these
    runners and their apps' stats views; add its K3 launches to the shape
    classes.  Returns the decode K3 launches."""
    import types
    want = _sum_launches(*(_expected_paged(r, types.SimpleNamespace(
        prefills=v["prefills"], decode_steps=v["decode_steps"]))
        for r, v in zip(runners, views)))
    if launches != want or not all(launches.values()):
        fail(f"park: launches {launches}, expected {want}")
    decode = sum((_norms_per_layer(r.cfg) * r.cfg.num_layers + 1)
                 * v["decode_steps"] for r, v in zip(runners, views))
    RMS_LAUNCHES["decode"] += decode
    RMS_LAUNCHES["prefill"] += launches["rmsnorm"] - decode
    return launches


def _tenants_run(torch, parker=None):
    """(a) Two full-width tinyllama-1.1b serve apps on one pod pool of
    ``PARK_POOL_PAGES`` pages and one aliased store, max batch 4: a0
    alone, then a1-a3 (prefix hits on a0's 2 cached pages) and b0-b3;
    8 steps of both.  (a1) a parks, b steps 8 times, one more request to a
    unparks it; twice more a parks, b steps twice, a unparks.  Both step
    until a's 40th decode step.  (a2) a parks, b parks (the store goes),
    b unparks, a unparks; both run to the end.  With ``parker`` None the
    same schedule runs with no park (the calm run).  Returns the tokens,
    margins, a's tokens at its 40th decode step, and the launches."""
    from repro_torch.core.history import HistoryStore
    from repro_torch.core.materializer import H100
    from repro_torch.launch.serve import submit_app
    from repro_torch.runtime import Cluster
    kernels = _paged_kernels()
    cluster = Cluster(pods=1, mesh=H100, history=HistoryStore(),
                      executor=_margin_executor())
    base, free0 = _requested(torch), cluster.capacity()["pod0"]["free_bytes"]
    a = submit_app(cluster, "tinyllama-1.1b", max_batch=4,
                   pool_pages=PARK_POOL_PAGES, prefix_cache=True,
                   name="park-a")
    b = submit_app(cluster, "tinyllama-1.1b", max_batch=4,
                   pool_pages=PARK_POOL_PAGES, name="park-b")
    store, shared = a.runner.store, cluster.pod_pool("pod0")
    if b.runner.store is not store:
        fail("park: the two tenants do not alias one store")
    ra, rb, extra = _park_requests(a.app.config.vocab_size)
    for fn in kernels.values():
        fn.launches = 0
    a.submit_request(ra[0])
    a.step()
    for r in ra[1:]:
        a.submit_request(r)
    for r in rb:
        b.submit_request(r)
    for _ in range(9):
        a.step()
        b.step()
    hits = a.stats_view.cumulative()["prefix_hits"]
    if (len(a.engine.running), len(b.engine.running), hits) != (4, 4, 3):
        fail(f"park: running {len(a.engine.running)}+{len(b.engine.running)}"
             f", prefix hits {hits} (expected 4+4, 3)")
    weights = _tree_bytes(a.runner.params)
    for cycle in range(3):
        if parker is not None:
            before = parker.park(a, f"(a1) a#{cycle}", drop=weights,
                                 drained=4)
        for _ in range(8 if cycle == 0 else 2):
            b.step()
        if cycle == 0:            # the submit unparks a transparently
            call = lambda: a.submit_request(extra)
            if parker is None:
                call()
        else:
            call = None
        if parker is not None:
            parker.unpark(a, f"(a1) a#{cycle}", restored=4, requeued=0,
                          call=call)
            parker.back(before, f"(a1) a#{cycle}")
    while a.engine.stats.decode_steps < 40:
        a.step()
        b.step()
    at40 = {rid: list(t) for rid, t in a.runner.generated.items()}
    if parker is not None:
        before = _requested(torch)
        parker.park(a, "(a2) a", drop=weights, drained=4)
        dropped = parker.receipts[-1][1]["kv_arrays_dropped"]
        store_bytes = store.device_bytes()
        parker.park(b, "(a2) b", drop=weights + store_bytes, drained=4)
        if dropped or not parker.receipts[-1][1]["kv_arrays_dropped"]:
            fail(f"park (a2): kv_arrays_dropped {dropped} for a, "
                 f"{parker.receipts[-1][1]} for b")
        if store.device_bytes() or any(c.num_pages for c in
                                       shared.prefix_caches.values()):
            fail("park (a2): the store or the prefix cache outlived the "
                 "last active tenant's park")
        parker.unpark(b, "(a2) b", restored=4, requeued=0)
        shared_reqs = sum(1 for r in ra if r.parked_shared)
        parker.unpark(a, "(a2) a", restored=4 - shared_reqs,
                      requeued=shared_reqs)
        parker.back(before, "(a2) both")
    alive = {"a": True, "b": True}
    while any(alive.values()):
        alive = {"a": a.step()["alive"], "b": b.step()["alive"]}
    launches = {name: fn.launches for name, fn in kernels.items()}
    _count_paged([a.runner, b.runner], [a.stats_view.cumulative(),
                                        b.stats_view.cumulative()], launches)
    out = {"tokens": {r.req_id: r.output_tokens for r in ra + rb + [extra]},
           "margins": _sum_margins([a.runner, b.runner]), "at40": at40,
           "launches": launches, "weights": weights,
           "store": store.device_bytes()}
    a.release()
    b.release()
    if abs(_requested(torch) - base) > PARK_SLACK or cluster.capacity()[
            "pod0"]["free_bytes"] != free0:
        fail(f"park: {_requested(torch) - base} bytes requested, "
             f"{cluster.capacity()['pod0']['free_bytes']} free bytes after "
             f"the releases ({free0} before the submits)")
    return out


def _launcher_calm():
    """The launcher's ``--autoscale`` traffic served by an app that is
    never parked: the same requests and bursts.  Returns the tokens."""
    from repro_torch.core.history import HistoryStore
    from repro_torch.core.materializer import H100
    from repro_torch.launch.serve import submit_app, synth_requests
    from repro_torch.runtime import Cluster, TorchExecutor
    cluster = Cluster(pods=1, mesh=H100, history=HistoryStore(),
                      executor=TorchExecutor(device="cuda", seed=0))
    h = submit_app(cluster, "tinyllama-1.1b", max_batch=8,
                   pool_pages=PARK_POOL_PAGES)
    reqs = synth_requests(8, h.app.config.vocab_size,
                          prompt_range=(64, 1024), max_new=32, seed=0)
    for burst in (reqs[:4], reqs[4:]):
        for r in burst:
            h.submit_request(r)
        h.run()
    h.release()
    return {r.req_id: r.output_tokens for r in reqs}


def _launcher_park(torch):
    """(b) The launcher's ``--autoscale`` path at full width (tinyllama-
    1.1b, 8 requests, 32 new tokens, the trace to a temporary file): the
    idle parker parks the app after the idle ticks, its weights leave the
    card, burst 2 unparks it, every request completes, the launches are
    what the path implies, the port's trace summary shows one park, one
    unpark and the controller's decisions, and every token equals an
    app's that was never parked.  Returns the launches."""
    import os
    import tempfile
    from repro_torch.launch.serve import serve
    from repro_torch.obs import load_events, summarize
    kernels = _paged_kernels()
    for fn in kernels.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        t0 = time.perf_counter()
        out = serve("tinyllama-1.1b", device="cuda", requests=8,
                    max_batch=8, pool_pages=PARK_POOL_PAGES,
                    prompt_range=(64, 1024), max_new=32, seed=0,
                    autoscale=True, trace=path, verbose=False)
        wall = time.perf_counter() - t0
        events = load_events(path)
    launches = {name: fn.launches for name, fn in kernels.items()}
    _count_paged([out["runner"]], [out["view"]], launches)
    auto, runner = out["autoscale"], out["runner"]
    weights = _tree_bytes(runner.params)
    fell = auto["before_park_bytes"] - auto["parked_bytes"]
    n = {name: sum(1 for e in events if e["cat"] == "autoscale"
                   and e["name"] == name)
         for name in ("park", "unpark", "decision")}
    text = summarize(events)
    print(f"[park] (b) launcher --autoscale: park {auto['park']}, "
          f"requested bytes fell by {fell} while parked (weights {weights}),"
          f" footprint parked {auto['parked_footprint']}; trace "
          f"{len(events)} events, autoscale {n}; completed "
          f"{out['view']['completed']}; launches {launches}; wall "
          f"{wall:.3f} s", flush=True)
    if not auto["parked"] or auto["park"] is None or not auto[
            "park"]["reason"].startswith("idle"):
        fail(f"park (b): the idle parker did not park the app: {auto}")
    if fell < weights - PARK_SLACK or auto["parked_footprint"] != 0:
        fail("park (b): the app's weights did not leave the card")
    if n["park"] != 1 or n["unpark"] != 1 or n["decision"] < 1 or (
            "== autoscale decisions ==" not in text):
        fail(f"park (b): the trace summary shows {n}")
    tokens = {r.req_id: r.output_tokens for r in out["requests"]}
    if out["view"]["completed"] != 8 or any(
            len(t or []) != 33 for t in tokens.values()):
        fail(f"park (b): {out['view']['completed']} of 8 completed")
    calm = _launcher_calm()
    if tokens != calm:
        fail("park (b): tokens differ from an app that was never parked")
    return launches


def _dense_run(torch, parker=None):
    """(c) Full-width zamba2-2.7b on the dense backend (a 2048-token cache
    a slot, max batch 3) serves phase 7's first 4 prompts with 32 new
    tokens: 8 steps, then (with ``parker``) a park and an unpark, then to
    the end; the fourth request is admitted after the restore.  Returns
    the tokens and the launches."""
    from repro_torch.core.history import HistoryStore
    from repro_torch.core.materializer import H100
    from repro_torch.launch.serve import submit_app, synth_requests
    from repro_torch.runtime import Cluster, TorchExecutor
    kernels = _dense_kernels()
    cluster = Cluster(pods=1, mesh=H100, history=HistoryStore(),
                      executor=TorchExecutor(device="cuda", seed=0))
    h = submit_app(cluster, "zamba2-2.7b", backend="dense", max_batch=3)
    reqs = synth_requests(8, h.app.config.vocab_size,
                          prompt_range=(64, 1024), max_new=32, seed=0)[:4]
    for fn in kernels.values():
        fn.launches = 0
    for r in reqs:
        h.submit_request(r)
    for _ in range(8):
        h.step()
    if parker is not None:
        drop = _tree_bytes(h.runner.params) + _tree_bytes(h.runner.cache)
        before = parker.park(h, "(c) zamba2", drop=drop, drained=3)
        parker.unpark(h, "(c) zamba2", restored=3, requeued=0)
        parker.back(before, "(c) zamba2")
    h.run()
    launches = {name: fn.launches for name, fn in kernels.items()}
    view = h.stats_view.cumulative()
    want = _expected_dense(h.runner.cfg, view["prefills"],
                           view["decode_steps"])
    if launches != want or view["completed"] != 4:
        fail(f"park (c): launches {launches}, expected {want}; completed "
             f"{view['completed']}")
    norms = want["rmsnorm"] // (view["prefills"] + view["decode_steps"])
    RMS_LAUNCHES["prefill"] += norms * view["prefills"]
    RMS_LAUNCHES["decode"] += norms * view["decode_steps"]
    tokens = {r.req_id: r.output_tokens for r in reqs}
    h.release()
    return tokens, {k: v for k, v in launches.items() if want[k]}


def _rings_run(torch, parker=None):
    """(d) Reduced gemma3-12b on ring pages on the card: 3 prompts of 200
    tokens, 70 new, 60 steps (259 tokens: past the 256-token rings), then
    3 park cycles with ``parker``, then to the end.  Returns the tokens
    and the launches."""
    import numpy as np
    from repro_torch.core.history import HistoryStore
    from repro_torch.runtime import (Application, Cluster, ServeOptions,
                                     TorchExecutor)
    from repro_torch.serving.kv_cache import Request
    kernels = _paged_kernels()
    cluster = Cluster(pods=1, history=HistoryStore(),
                      executor=TorchExecutor(device="cuda", seed=0))
    h = cluster.submit(Application.serve(
        "gemma3-12b", reduced=True, name="park-rings",
        serve=ServeOptions(max_batch=4, pool_pages=32, cache_len=512,
                           policy="history", backend="paged")))
    rng = np.random.default_rng(0)
    vocab = h.app.config.vocab_size
    reqs = [Request(f"g{i}", 200, 70, prompt_tokens=tuple(
        rng.integers(0, vocab, 200).tolist())) for i in range(3)]
    for fn in kernels.values():
        fn.launches = 0
    for r in reqs:
        h.submit_request(r)
    for _ in range(60):
        h.step()
    for cycle in range(3 if parker is not None else 0):
        drop = _tree_bytes(h.runner.params)
        before = parker.park(h, f"(d) gemma3 rings#{cycle}", drop=drop,
                             drained=3)
        parker.unpark(h, f"(d) gemma3 rings#{cycle}", restored=3,
                      requeued=0)
        parker.back(before, f"(d) gemma3 rings#{cycle}")
    h.run()
    launches = {name: fn.launches for name, fn in kernels.items()}
    _count_paged([h.runner], [h.stats_view.cumulative()], launches)
    tokens = {r.req_id: r.output_tokens for r in reqs}
    if any(len(t or []) != 71 for t in tokens.values()):
        fail(f"park (d): tokens {[len(t or []) for t in tokens.values()]}")
    h.release()
    return tokens, launches


def serve_park(torch):
    """Phase 13.  (a) two aliased full-width tinyllama-1.1b tenants: a
    parked three times while b serves, then both parked (the store goes
    with b, the last active one) and unparked; every restored request's
    tokens exactly a calm run's, a's requeued ones under the ``TIE_GAP``
    rule; (b) the launcher's ``--autoscale`` path; (c) a dense zamba2-2.7b
    park; (d) a reduced gemma3-12b ring park after the rings wrapped.
    Every park frees the job's bytes and at least its weights' (plus the
    store's or the dense cache's where they go) on the card, less 1 MiB,
    and every unpark brings the allocator back within 1 MiB.  Prints each
    park's and unpark's wall time and host-transfer rate.  Returns the
    launches by kernel name."""
    import gc
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    # the process's first GEMM makes cuBLAS's workspace (32 MiB), which
    # stays: make it before the runs read the allocator's bytes
    x = torch.ones(64, 64, device="cuda", dtype=torch.bfloat16)
    x = x @ x
    del x
    parker = _Parker(torch)
    calm = _tenants_run(torch)
    parked = _tenants_run(torch, parker)
    launches = _sum_launches(calm["launches"], parked["launches"])
    # b0-b3 are restored in (a2) and decode in b's own batch to the end;
    # a0-a3 were restored three times in (a1) (held at a's decode step
    # 40) and are requeued in (a2), and a-extra decodes beside the
    # recomputed a0-a3: those are held under the TIE_GAP rule
    restored = {rid: t for rid, t in calm["tokens"].items()
                if rid.startswith("b")}
    if {rid: parked["tokens"][rid] for rid in restored} != restored:
        fail("park (a): a restored request's tokens differ from the calm "
             "run's")
    if parked["at40"] != calm["at40"]:
        fail("park (a1): a's tokens at its 40th decode step differ from "
             "the calm run's")
    flips = check_parity({rid: t for rid, t in calm["tokens"].items()
                          if rid not in restored}, parked["tokens"],
                         calm["margins"], TIE_GAP)
    print(f"[park] (a) tinyllama-1.1b x 2 on one store "
          f"({parked['store'] / 2**20:.1f} MiB), weights "
          f"{parked['weights']} bytes an app: restored tokens exactly the "
          f"calm run's (b0-b3; a0-a3 up to a's decode step 40), a0-a3 "
          f"requeued and recomputed and a-extra: {flips} near-tie flips; "
          f"launches {launches}", flush=True)
    for label, receipt in parker.receipts:
        print(f"[park] {label}: {receipt}", flush=True)
    for name, n in _launcher_park(torch).items():
        launches[name] = launches.get(name, 0) + n
    dense_calm, n_calm = _dense_run(torch)
    dense, n_park = _dense_run(torch, parker)
    if dense != dense_calm:
        fail("park (c): zamba2's tokens differ from the calm run's")
    launches = _sum_launches(launches, n_calm, n_park)
    rings_calm, n_calm = _rings_run(torch)
    rings, n_park = _rings_run(torch, parker)
    if rings != rings_calm:
        fail("park (d): the wrapped rings' tokens differ from the calm "
             "run's")
    launches = _sum_launches(launches, n_calm, n_park)
    print(f"[park] (c) zamba2-2.7b dense and (d) reduced gemma3-12b rings: "
          f"tokens exactly the calm runs'", flush=True)
    for label, wall, moved, fell in parker.moves:
        freed = "" if fell is None else f", {fell} bytes freed on the card"
        print(f"[park] {label}: {wall * 1e3:.3f} ms, {moved} bytes moved, "
              f"{moved / wall / 1e9:.3f} GB/s{freed} | {card}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[park] phase 13: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def check_parity(ref_toks, toks, ref_margins, tie_gap) -> int:
    """Equal tokens, except that a request may diverge at a step where the
    reference run's top-2 logit gap was below ``tie_gap``; after that the
    two sequences continue from different tokens and are not compared.
    Returns the number of such near-tie divergences."""
    flips = 0
    for rid, want in ref_toks.items():
        got = toks[rid]
        if got is None or len(got) != len(want):
            fail(f"parity: {rid} has {got} vs {want}")
        for j, (a, b) in enumerate(zip(want, got)):
            if a != b:
                gap = ref_margins[rid][j]
                if gap >= tie_gap:
                    fail(f"parity: {rid} token {j}: {b} vs {a} at a top-2 "
                         f"gap of {gap:.3e} >= {tie_gap}")
                flips += 1
                break
    return flips


# ---------------------------------------------------------------------------
# phases 14 and 15: full-width training of the recurrent families
# ---------------------------------------------------------------------------

def train_zamba2_full(torch):
    """Phase 14: zamba2-2.7b at full width (54 layers: 9 x (5 Mamba-2 + the
    shared attention block), d 2560, heads of 80) under ``remat="dots"``
    in 4 microbatches, phase 5's shape and steps (:func:`train_phase`).
    Under ``dots`` each pattern block keeps its matmuls' outputs and runs
    the rest again in the backward, every kernel's forward with it (but
    for ``ln_f``'s norm, outside the blocks).  Returns the launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN_SHARED, MAMBA2
    cfg = get_config("zamba2-2.7b")
    mamba = cfg.pattern.count(MAMBA2) * cfg.num_blocks
    attn = cfg.pattern.count(ATTN_SHARED) * cfg.num_blocks
    norms = 2 * mamba + 3 * attn          # ln1 + inner; ln_in, ln1, ln2
    return train_phase(torch, "train zamba2", cfg,
                       {"remat": "dots", "microbatch": 4}, {
                           "ssd_scan": 2 * mamba,
                           "flash_attention_fwd": 2 * attn,
                           "flash_attention_bwd_dq": attn,
                           "flash_attention_bwd_dkv": attn,
                           "rmsnorm": 2 * norms + 1,
                           "rmsnorm_bwd": norms + 1})[0]


def train_rwkv6_full(torch):
    """Phase 15: rwkv6-7b at full width (d 4096, 64 heads of 64) with 8 of
    its 32 layers (the full depth needs more than one card: ``PERF.md``
    §4) under full remat in 4 microbatches, phase 5's shape and steps
    (:func:`train_phase`).  Returns the launch counts."""
    from repro_torch.configs import get_config
    cfg = get_config("rwkv6-7b").scaled(num_layers=8)
    n = cfg.num_layers
    return train_phase(torch, "train rwkv6", cfg,
                       {"remat": "full", "microbatch": 4}, {
                           "rwkv6_wkv": 2 * n, "rmsnorm": 2 * (2 * n) + 1,
                           "rmsnorm_bwd": 2 * n + 1})[0]


# ---------------------------------------------------------------------------
# phase 18: full-width training of the MoE, vision-language and
# encoder-decoder families
# ---------------------------------------------------------------------------

# phase 18 (b): phi-3-vision's depth.  At its full 32 layers the step
# needs more than the card (77.29 GiB allocated at the failure); 28
# peaks at 70.732 GiB (PERF.md section 4).  Phase 18 runs with the
# allocator's expandable segments: with fixed segments the cache that
# the earlier phases and runs leave fragmented (8.99 GiB reserved but
# free at the failure) ran 28 layers out of the card
PHI3_TRAIN_LAYERS = 28


@contextmanager
def train_call_classes():
    """Count the flash-attention launches of a training run by call
    shape while the block runs: K2's, K5a's and K5b's by (causal, Sq, Sk,
    window).  A call counts where the kernel wrapper's own count rose.  The
    model reaches K2 through ``FlashAttention.apply`` in
    ``models/attention.py`` (again in a remat recompute), and K5 through
    ``flash_attention_bwd`` in ``kernels/flash_attention.py``, which
    ``FlashAttention``'s backward calls; both names are wrapped (the
    kernel wrappers themselves count by their own names, so they are
    left as they are)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn
    function, bwd = attn.FlashAttention, fa.flash_attention_bwd
    parts = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    seen = {n: {} for n in ("flash_attention_fwd",) + parts}

    def tally(names, before, key):
        for n, b in zip(names, before):
            if getattr(fa, n).launches > b:
                seen[n][key] = seen[n].get(key, 0) + 1

    class Counted:
        @staticmethod
        def apply(q, k, v, causal, window, q_offset):
            before = [fa.flash_attention_fwd.launches]
            o = function.apply(q, k, v, causal, window, q_offset)
            tally(("flash_attention_fwd",), before,
                  (bool(causal), q.shape[2], k.shape[2], int(window)))
            return o

    def counted_bwd(q, k, v, o, lse, do, *, causal=True, window=0, **kw):
        before = [getattr(fa, n).launches for n in parts]
        out = bwd(q, k, v, o, lse, do, causal=causal, window=window, **kw)
        tally(parts, before, (bool(causal), q.shape[2], k.shape[2],
                              int(window)))
        return out

    attn.FlashAttention, fa.flash_attention_bwd = Counted, counted_bwd
    try:
        yield seen
    finally:
        attn.FlashAttention, fa.flash_attention_bwd = function, bwd


def _attention_counts(n):
    """A microbatch's kernel launches under full remat for ``n`` RoPE
    attention blocks normed by RMSNorm (ln1, ln2): K2 in the forward and
    the recompute, K5a and K5b once, K3 in both and once more for
    ``ln_f``, its backward once a norm."""
    return {"flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkv": n, "rmsnorm": 2 * (2 * n) + 1,
            "rmsnorm_bwd": 2 * n + 1}


@contextmanager
def expandable_segments(torch):
    """The caching allocator maps new segments in pieces that grow in
    place (``expandable_segments``) while the block runs, so freed blocks
    merge into the space a larger request needs; the cached free blocks
    go back to the card on entry and on exit."""
    setting = "expandable_segments:{}"
    before = setting.format(True) in os.environ.get(
        "PYTORCH_CUDA_ALLOC_CONF", "")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings(setting.format(True))
    try:
        yield
    finally:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings(setting.format(before))


def train_families_full(torch):
    """Phase 18: the MoE, vision-language and encoder-decoder families
    train at full width on one card, at phase 5's sequence 4096 x batch 8
    and optimizer (random weights from seed 0, each run's memory freed
    before the next, the allocator's segments expandable:
    :func:`expandable_segments`), each through :func:`train_phase` with
    all its gates.  (a) qwen2-moe-a2.7b with 4 of its 24 layers (the full
    depth needs more than one card) under full remat in 4 microbatches,
    the CE in chunks of 1024 positions, 4 steps through ``launch.train``,
    with the pairs the capacity drops in each step and the step-1 batch's
    aux beside its ce; (b) phi-3-vision-4.2b at ``PHI3_TRAIN_LAYERS``
    layers through ``launch.train`` on its text alone, as the runtime's
    batches hold it, full remat in 8 microbatches of one sequence
    (``img_proj``, which text does not reach, takes a zero gradient); (c)
    phi-3-vision-4.2b with 4 of its 32 layers through ``make_train_step``
    with 576 seeded image embeddings ahead of 3520 tokens, full remat in 4
    microbatches, 3 steps, ``img_proj``'s gradient nonzero; (d)
    whisper-base through ``make_train_step`` with seeded 1500 frames, full
    remat in 4 microbatches, 4 steps, the encoder's and ``cross_w*``'s
    gradients nonzero, K2 twice per attention call and K5a/K5b once by
    call shape (causal self, cross, encoder), no K3 (whisper norms with
    LayerNorm).  Returns the launch counts summed and the launches of the
    ``*_d96``, ``*_d128`` and ``*_whisper_*train`` records."""
    from repro_torch.configs import get_config
    full = {"remat": "full", "microbatch": 4}
    qwen = get_config("qwen2-moe-a2.7b").scaled(num_layers=4)
    phi = get_config("phi-3-vision-4.2b")
    phi_b = phi.scaled(num_layers=PHI3_TRAIN_LAYERS)
    phi_c = phi.scaled(num_layers=4)
    whisper = get_config("whisper-base")
    n = whisper.num_layers
    frames = whisper.encoder_seq_len
    seq, mb, steps = _train_setup()[0].seq_len, full["microbatch"], 4
    calls = {(True, seq, seq, 0): n, (False, seq, frames, 0): n,
             (False, frames, frames, 0): whisper.num_encoder_layers}
    with expandable_segments(torch):
        # the CE over 151936 ids in chunks of 1024 positions: a
        # microbatch's fp32 logits (4.98 GB) and their gradient ran the
        # card out of memory
        a, _ = train_phase(torch, "train qwen2-moe", qwen,
                           dict(full, loss_chunk=1024),
                           _attention_counts(qwen.num_layers))
        b, _ = train_phase(torch, "train phi-3 text", phi_b,
                           {"remat": "full", "microbatch": 8},
                           _attention_counts(phi_b.num_layers),
                           unreached=("img_proj",))
        c, _ = train_phase(torch, "train phi-3 images", phi_c, full,
                           _attention_counts(phi_c.num_layers), steps=3,
                           direct=True)
        d, classes = train_phase(torch, "train whisper", whisper, full, {
            "flash_attention_fwd": 2 * sum(calls.values()),
            "flash_attention_bwd_dq": sum(calls.values()),
            "flash_attention_bwd_dkv": sum(calls.values())}, steps=steps,
            direct=True)
    for name, per in (("flash_attention_fwd", 2), ("flash_attention_bwd_dq", 1),
                      ("flash_attention_bwd_dkv", 1)):
        want = {key: per * n_calls * mb * steps
                for key, n_calls in calls.items()}
        if classes[name] != want:
            fail(f"train whisper: {name} launches by call shape "
                 f"{classes[name]}, expected {want}")
    launches = _sum_launches(a, b, c, d)
    records = {}
    for part in ("dq", "dkv"):
        name = f"flash_attention_bwd_{part}"
        records[f"{name}_d96"] = b[name] + c[name]
        records[f"{name}_d128"] = a[name]
        records[f"{name}_whisper_train"] = \
            classes[name][(False, seq, frames, 0)]
        records[f"{name}_whisper_enc_train"] = \
            classes[name][(False, frames, frames, 0)]
    records["flash_attention_fwd_whisper_train"] = \
        classes["flash_attention_fwd"][(False, seq, frames, 0)]
    RMS_LAUNCHES["train"] += a["rmsnorm"] + d["rmsnorm"]
    RMS_LAUNCHES["train 3072"] += b["rmsnorm"] + c["rmsnorm"]
    return launches, records


# ---------------------------------------------------------------------------
# phase 19: full-width gemma3-12b training
# ---------------------------------------------------------------------------

# phase 19: gemma3-12b's depth and plan.  Two of its 5:1 periods (10
# local layers, 2 global), the deepest whole number of periods whose plan
# fits the card at 4096 x 8: 18 layers plan 79.77 GiB, the full 48 180.85
# (refused).  One sequence a microbatch, and the CE in chunks of 1024
# positions: one sequence's fp32 logits over 262144 ids are 4.29 GB, and
# their gradient as much again
GEMMA3_TRAIN_LAYERS = 12
GEMMA3_OVERRIDES = {"remat": "full", "microbatch": 8, "loss_chunk": 1024}


def refused_before_weights(torch, tag, cfg, shape, overrides):
    """``launch.train`` of ``cfg`` at ``shape`` with ``overrides`` must
    raise before any weights are made (``TorchExecutor.init_params`` is
    not reached and nothing is allocated on the card), naming its plan's
    estimate: host arithmetic."""
    from repro_torch.core.materializer import H100, materialize
    from repro_torch.launch.train import train
    from repro_torch.runtime import TorchExecutor
    plan = materialize(cfg, shape, H100, overrides=overrides)
    want = f"{plan.est_bytes_per_device / 2**30:.2f} GiB"
    plain, made, said = TorchExecutor.init_params, [], None
    TorchExecutor.init_params = lambda self, handle: made.append(handle)
    before = torch.cuda.memory_allocated()
    try:
        train(cfg, shape=shape, overrides=overrides, device="cuda", steps=1,
              verbose=False)
    except RuntimeError as e:
        said = str(e)
    finally:
        TorchExecutor.init_params = plain
    print(f"[{tag}] {cfg.name} at {cfg.num_layers} layers, {shape.name}, "
          f"overrides {overrides}: {said}", flush=True)
    if said is None or want not in said or made \
            or torch.cuda.memory_allocated() != before:
        fail(f"{tag}: {cfg.name} at {cfg.num_layers} layers was not refused "
             f"before any weights were made, naming its {want} plan")


def train_gemma3_full(torch):
    """Phase 19: gemma3-12b at full width (d 3840, 16/8 heads of 256, d_ff
    15360, vocab 262144, tied embeddings) trains at phase 5's sequence
    4096 x batch 8 and optimizer with ``GEMMA3_TRAIN_LAYERS`` of its 48
    layers (10 sliding-window layers of window 1024, 2 global), under
    ``GEMMA3_OVERRIDES``, 4 steps through ``launch.train``
    (:func:`train_phase`, all its gates; the allocator's segments
    expandable), after the full depth is refused before any weights are
    made (:func:`refused_before_weights`).  Each layer norms four times
    (ln1, ln2, and the q- and k-norms over its heads); K2, K5a and K5b at
    head dim 256 are counted by call shape, windowed and global apart.
    Returns the launch counts and the launches of the ``*_d256_local*``
    and ``*_d256_global*`` training records."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL
    gemma3 = get_config("gemma3-12b")
    shape = _train_setup()[0]
    refused_before_weights(torch, "train gemma3", gemma3, shape,
                           GEMMA3_OVERRIDES)
    cfg = gemma3.scaled(num_layers=GEMMA3_TRAIN_LAYERS)
    n, seq, steps = cfg.num_layers, shape.seq_len, _train_setup()[3]
    calls = {(True, seq, seq, cfg.sliding_window):
             cfg.pattern.count(ATTN_LOCAL) * cfg.num_blocks,
             (True, seq, seq, 0):
             cfg.pattern.count(ATTN_GLOBAL) * cfg.num_blocks}
    with expandable_segments(torch):
        launches, classes = train_phase(
            torch, "train gemma3", cfg, GEMMA3_OVERRIDES,
            dict(_attention_counts(n), rmsnorm=2 * (4 * n) + 1,
                 rmsnorm_bwd=4 * n + 1))
    mb = GEMMA3_OVERRIDES["microbatch"]
    records = {}
    for name, per in (("flash_attention_fwd", 2), ("flash_attention_bwd_dq", 1),
                      ("flash_attention_bwd_dkv", 1)):
        want = {key: per * n_calls * mb * steps
                for key, n_calls in calls.items()}
        if classes[name] != want:
            fail(f"train gemma3: {name} launches by call shape "
                 f"{classes[name]}, expected {want}")
        tail = "_train" if name == "flash_attention_fwd" else ""
        for (_, _, _, window), n_calls in want.items():
            kind = "local" if window else "global"
            records[f"{name}_d256_{kind}{tail}"] = n_calls
    RMS_LAUNCHES["train gemma3"] += launches["rmsnorm"]
    return launches, records


# ---------------------------------------------------------------------------
# phase 20: sharded training over four ranks
# ---------------------------------------------------------------------------

SHARDED_WORLD = 4                 # the h100x4 mesh, (2, 2) over (data, model)
# the last step profiled on rank 0: two steps, so that the phase stays
# near 150 s on one card, where gloo reduces through the host (a third,
# unprofiled step took 12-21 s a plan there)
SHARDED_STEPS = 2
# the ladder's own plan on h100x4 at batch 8 under phase 5's remat, and the
# TP + ZeRO + FSDP plan the ladder picks at train_4k's batch of 256
SHARDED_PLANS = {
    "dp": {"remat": "full", "microbatch": 2},
    "tp": {"tp": True, "zero": True, "fsdp": True, "batch_axes": ("data",),
           "remat": "full", "microbatch": 2},
}
SHARDED_TIMEOUT_S = 900


@contextmanager
def first_update_grads(store):
    """The gradient tree the train step's first ``adamw_update`` call is
    handed (averaged over the batch, before clipping; on a mesh the rank's
    optimizer slices), copied to the host into ``store``."""
    from repro_torch.training import optimizer as opt
    plain = opt.adamw_update

    def spy(grads, *args, **kwargs):
        if not store:
            store.append([g.detach().cpu() for g in opt.leaves(grads)])
        return plain(grads, *args, **kwargs)

    opt.adamw_update = spy
    try:
        yield store
    finally:
        opt.adamw_update = plain


@contextmanager
def profiled_train_step(torch, index, result):
    """The ``TorchExecutor``'s train step number ``index`` (None: none)
    under ``torch.profiler`` while the block runs; ``result`` gets its
    wall, the device busy time, the NCCL kernels' device time and the
    host time inside gloo's collectives (gloo reduces on the host), in
    ms."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.executors import TorchExecutor
    plain = TorchExecutor.train_step

    def train_step(self, handle):
        if handle.cursor != index:
            return plain(self, handle)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            m = plain(self, handle)            # waits for the step
            wall = time.perf_counter() - t0
        avgs = prof.key_averages()
        dev_us = {e.key: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
                  for e in avgs
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and not getattr(e, "is_user_annotation", False)}
        result.update(
            wall_ms=wall * 1e3, busy_ms=sum(dev_us.values()) / 1e3,
            nccl_ms=sum(t for k, t in dev_us.items()
                        if "nccl" in k.lower()) / 1e3,
            gloo_host_ms=sum(e.cpu_time_total for e in avgs
                             if e.key.startswith("gloo:")) / 1e3)
        return m

    TorchExecutor.train_step = train_step
    try:
        yield result
    finally:
        TorchExecutor.train_step = plain


def _sharded_reference(torch, cfg, shape, ocfg):
    """The one-card run phase 20 holds the ranks against: phase 5's plan,
    weights (seed 0) and batches, ``SHARDED_STEPS`` steps of
    ``make_train_step`` -> (losses, step-1 gradients, final params), the
    tensors on the host."""
    from repro_torch.core.materializer import H100, materialize
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model, init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import impl_from_plan, make_train_step
    plan = materialize(cfg, shape, H100, overrides=_train_setup()[1])
    model = Model(cfg, impl_from_plan(plan))
    params = init_params(cfg, 0, "cuda")
    state = opt.init_opt_state(params)
    step = make_train_step(model, plan, ocfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, shape.seq_len,
                                  shape.global_batch))
    losses, grads = [], []
    with first_update_grads(grads):
        for i in range(SHARDED_STEPS):
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in data.batch_at(i).items()}
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
    final = [p.cpu() for p in opt.leaves(params)]
    del params, state, step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return losses, grads[0], final


def train_sharded(torch):
    """Phase 20: full-width tinyllama-1.1b trained over the four ranks of
    the ``h100x4`` mesh through ``launch.train`` (``Cluster.submit``, the
    ``TorchExecutor`` on each rank), with each plan of ``SHARDED_PLANS``,
    ``SHARDED_STEPS`` steps at phase 5's sequence 4096 x batch 8 and
    optimizer, against one card's run of phase 5's plan on the same
    seeded weights and batches (here, first; its step-1 gradients and
    final params go to the ranks through a file, each rank compares its
    own blocks).  NCCL, a rank a card, with four cards; else gloo, every
    rank on ``cuda:0``.  Returns the launch counts of rank 0's runs."""
    import tempfile
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = get_config("tinyllama-1.1b")
    shape, _, ocfg, _ = _train_setup()
    ref_losses, ref_grads, ref_params = _sharded_reference(torch, cfg, shape,
                                                           ocfg)
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= SHARDED_WORLD else "gloo"
    print(f"[sharded] one card's run (phase 5's plan, {SHARDED_STEPS} steps): "
          f"losses {ref_losses}, {time.perf_counter() - t_phase:.1f} s; "
          f"{SHARDED_WORLD} ranks over {backend} on {cards} card(s) | "
          f"{card_line()}", flush=True)
    launches = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        torch.save({"grads": ref_grads, "params": ref_params},
                   f"{d}/reference.pt")
        del ref_grads, ref_params
        _spawn_ranks(d, backend)
        for name in SHARDED_PLANS:
            for k, n in _sharded_gates(d, name, ref_losses).items():
                launches[k] = launches.get(k, 0) + n
    print(f"[sharded] phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def _spawn_ranks(d, backend):
    """Start the ``SHARDED_WORLD`` rank processes (:func:`sharded_rank`)
    and wait for them; every one must exit 0 within the timeout, and none
    outlives this call."""
    procs = []
    for r in range(SHARDED_WORLD):
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                f"import chip_smoke; chip_smoke.sharded_rank({r}, "
                f"{SHARDED_WORLD}, {d!r}, {backend!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT,
            env=dict(os.environ, LOCAL_RANK=str(r))))
    deadline = time.time() + SHARDED_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        fail(f"sharded: rank exit codes {codes}")


def sharded_rank(rank, world, d, backend):
    """One rank of phase 20: joins the world (a ``file://`` store in
    ``d``) on its card, runs each plan of ``SHARDED_PLANS``
    (:func:`_sharded_run`) and leaves its reports in ``d``; any failure
    ends the process with a nonzero code."""
    import traceback
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dist.init_process_group(backend, init_method=f"file://{d}/rendezvous",
                                rank=rank, world_size=world)
        from repro_torch.launch.mesh import rank_device
        torch.cuda.set_device(rank_device(torch.device("cuda")))
        for name, overrides in SHARDED_PLANS.items():
            _sharded_run(torch, rank, d, name, overrides, backend)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)              # the other ranks would wait on this one


def _block_errs(torch, local, whole, layouts, mesh, dev):
    """Per leaf, the squared norms of (this rank's block - the same block
    of ``whole``, a host tree) and of that block, on the card in fp32 and
    summed in fp64 over the mesh, each distinct block once (the rank at
    coordinate 0 along every axis the leaf is not split over counts it)
    -> a (leaves, 2) float64 tensor."""
    import torch.distributed as dist
    sums = torch.zeros(len(local), 2, dtype=torch.float64, device=dev)
    for i, (t, w, lay) in enumerate(zip(local, whole, layouts)):
        if all(c == 0 for a, c in mesh.coords.items()
               if a not in lay.split_axes):
            b = lay.local(w).to(dev).float()
            sums[i, 0] = (t.to(dev).float() - b).square().sum(
                dtype=torch.float64)
            sums[i, 1] = b.square().sum(dtype=torch.float64)
    dist.all_reduce(sums)
    return sums.cpu()


def _sharded_run(torch, rank, d, name, overrides, backend):
    """One plan on this rank: ``launch.train`` on ``h100x4`` with the
    kernels' counts zeroed just before and read just after (the last
    step profiled on rank 0); its step-1 gradients (the first
    ``adamw_update``'s) and final params held block by block against the
    one-card run's; for the TP plan, the params saved from the ranks'
    blocks and restored onto a (4, 1) mesh bit for bit.  The report goes
    to ``d/<name>_<rank>.json``."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import TorchMesh
    from repro_torch.launch.train import train
    from repro_torch.models.model import param_specs
    from repro_torch.sharding.planner import plan_layouts
    from repro_torch.training import optimizer as opt
    cfg = get_config("tinyllama-1.1b")
    shape, _, ocfg, _ = _train_setup()
    kernels = _train_kernels()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", torch.cuda.current_device())
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in kernels.values():
        fn.launches = 0
    grads, prof, t0 = [], {}, time.perf_counter()
    with first_update_grads(grads), profiled_train_step(
            torch, SHARDED_STEPS - 1 if rank == 0 else None, prof):
        out = train(cfg, shape=shape, overrides=overrides, opt_cfg=ocfg,
                    device="cuda", steps=SHARDED_STEPS, seed=0,
                    mesh="h100x4", dist_backend=backend, verbose=rank == 0)
    torch.cuda.synchronize(dev)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev) - base
    if out["device"] != dev:
        raise RuntimeError(f"rank {rank} trained on {out['device']}, not "
                           f"on its card {dev}")
    t_train, t0 = time.perf_counter() - t0, time.perf_counter()
    mesh = TorchMesh(out["plan"].mesh)
    lay = plan_layouts(out["plan"], cfg, param_specs(cfg), mesh)
    ref = torch.load(f"{d}/reference.pt", mmap=True)
    grad_sums = _block_errs(torch, grads[0], ref["grads"],
                            opt.leaves(lay.opt), mesh, dev)
    param_sums = _block_errs(torch, opt.leaves(out["params"]),
                             ref["params"], opt.leaves(lay.params), mesh, dev)
    del ref
    report = {"plan": {k: v for k, v in out["plan"].describe().items()
                       if k != "notes"},
              "losses": [m["loss"] for m in out["metrics"]],
              "walls": [m["wall_s"] for m in out["metrics"]],
              "launches": launches, "peak": peak, "grant": out["grant"],
              "held": out["held"], "device": str(dev), "profile": prof,
              "grad_errs": (grad_sums[:, 0] / grad_sums[:, 1]).sqrt()
              .tolist(),
              "param_err": float((param_sums[:, 0].sum()
                                  / param_sums[:, 1].sum()).sqrt())}
    t_gates, t0 = time.perf_counter() - t0, time.perf_counter()
    if name == "tp":
        report["restored_41"], report["restored_one"] = _restore_checks(
            torch, d, cfg, out, lay, dev, rank)
    report["seconds"] = {"train": t_train, "gates": t_gates,
                         "restore": time.perf_counter() - t0}
    del out
    with open(f"{d}/{name}_{rank}.json", "w") as f:
        json.dump(report, f)
    dist.barrier()


def _restore_checks(torch, d, cfg, out, lay, dev, rank):
    """The TP plan's final params saved from the ranks' blocks (rank 0
    writes the whole leaves), restored onto a (4, 1) mesh on every rank
    and, with no mesh, whole in rank 0's process -> (whether every block
    this rank restored is bit-equal to its block of the whole params; on
    rank 0 whether the whole restore is bit-equal to them, else None)."""
    import dataclasses
    from repro_torch.checkpoint.checkpointer import (restore_checkpoint,
                                                     save_checkpoint)
    from repro_torch.core.materializer import MeshSpec
    from repro_torch.launch.mesh import TorchMesh
    from repro_torch.models.model import param_specs
    from repro_torch.sharding.collectives import gather_full
    from repro_torch.sharding.planner import plan_layouts
    from repro_torch.training import optimizer as opt
    ckpt = f"{d}/ckpt"
    save_checkpoint(ckpt, SHARDED_STEPS, out["params"], extra={"plan": "tp"},
                    layouts=lay.params)
    spec41 = MeshSpec("h100x4_41", (4, 1), ("data", "model"))
    lay41 = plan_layouts(dataclasses.replace(out["plan"], mesh=spec41), cfg,
                         param_specs(cfg), TorchMesh(spec41)).params
    specs = param_specs(cfg)
    like41 = opt.tree_unflatten(specs, [
        torch.empty(l41.local_shape(s.shape), dtype=torch.bfloat16,
                    device=dev)
        for s, l41 in zip(opt.leaves(specs), opt.leaves(lay41))])
    restored, _, _ = restore_checkpoint(ckpt, SHARDED_STEPS, like41,
                                        shardings=lay41)
    whole = None
    if rank == 0:
        whole, _, _ = restore_checkpoint(ckpt, SHARDED_STEPS, opt.tree_map(
            lambda s: torch.empty(s.shape, dtype=torch.bfloat16,
                                  device=dev), specs))
    eq41, eq_one = True, rank == 0 or None
    for i, (r, p, lp, l41) in enumerate(zip(
            opt.leaves(restored), opt.leaves(out["params"]),
            opt.leaves(lay.params), opt.leaves(lay41))):
        full = gather_full(p, lp)
        eq41 = eq41 and torch.equal(r, l41.local(full))
        if whole is not None:
            eq_one = eq_one and torch.equal(opt.leaves(whole)[i], full)
        del full
    return eq41, eq_one


def _sharded_gates(d, name, ref_losses):
    """Phase 20's gates on one plan's rank reports (see the module doc);
    returns rank 0's launch counts."""
    from repro_torch.configs import get_config
    reports = []
    for r in range(SHARDED_WORLD):
        with open(f"{d}/{name}_{r}.json") as f:
            reports.append(json.load(f))
    r0 = reports[0]
    cfg = get_config("tinyllama-1.1b")
    plan, losses = r0["plan"], r0["losses"]
    per_mb = _attention_counts(cfg.num_layers)
    want = {k: per_mb.get(k, 0) * plan["microbatch"] * SHARDED_STEPS
            for k in r0["launches"]}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    grad_err, param_err = max(r0["grad_errs"]), r0["param_err"]
    prof, walls = r0["profile"], r0["walls"]
    print(f"[sharded {name}] plan batch_axes={plan['batch_axes']} "
          f"tp={plan['tp']} zero={plan['zero']} fsdp={plan['fsdp']} "
          f"remat={plan['remat']} microbatch={plan['microbatch']}, est "
          f"{plan['est_bytes_per_device'] / 2**30:.3f} GiB/device; peaks "
          f"{[round(r['peak'] / 2**30, 3) for r in reports]} GiB on "
          f"{[r['device'] for r in reports]}, grant "
          f"{r0['grant'] / 2**30:.3f} GiB over {r0['held'] / 2**30:.3f} GiB "
          f"held; losses {losses} (one card {ref_losses}, max rel "
          f"{loss_err:.3e} <= {TRAIN_LOSS_RTOL}), params rel norm "
          f"{param_err:.3e} <= {TRAIN_PARAM_RTOL}, step-1 grads worst rel "
          f"norm {grad_err:.3e} <= {TRAIN_GRAD_RTOL}; step "
          f"{prof['wall_ms'] / 1e3:.4f} s (the last, under rank 0's "
          f"profiler; the runtime's walls {[round(w, 4) for w in walls]} "
          f"count the profile's report too); launches {r0['launches']} "
          f"expected {want}; rank 0's "
          f"seconds {r0['seconds']} | {card_line()}", flush=True)
    print(f"[sharded {name}] rank 0's profiled step: wall "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms; "
          f"collectives: NCCL kernels {prof['nccl_ms']:.1f} ms "
          f"({prof['nccl_ms'] / max(prof['busy_ms'], 1e-9):.4f} of the busy "
          f"time), host time in gloo's collectives {prof['gloo_host_ms']:.1f}"
          f" ms ({prof['gloo_host_ms'] / prof['wall_ms']:.4f} of the wall)",
          flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"sharded {name}: losses {losses} not finite or not decreasing")
    if r0["launches"] != want:
        fail(f"sharded {name}: rank 0's launch counts differ from what the "
             "path implies")
    if not all(r0["grant"] >= r["held"] >= r["peak"] for r in reports) or \
            any(r["grant"] != r0["grant"] for r in reports):
        fail(f"sharded {name}: the grant does not cover every rank's peak")
    if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_RTOL
            and grad_err <= TRAIN_GRAD_RTOL):
        fail(f"sharded {name}: the ranks' run disagrees with one card's")
    if name == "tp":
        one = r0["restored_one"]
        print(f"[sharded {name}] saved from the ranks' blocks, restored onto "
              f"a (4, 1) mesh: bit-equal on "
              f"{sum(r['restored_41'] for r in reports)} of {SHARDED_WORLD} "
              f"ranks; whole in one process (rank 0's): bit-equal {one}",
              flush=True)
        if not (one and all(r["restored_41"] for r in reports)):
            fail(f"sharded {name}: the restore is not bit-equal")
    return r0["launches"]

if __name__ == "__main__":
    main()
