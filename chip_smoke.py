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
   rows, a prefill's 1000, a training norm's 8192, at widths 2048-5120)
   and its backward (``rmsnorm_bwd``) held against ``rmsnorm_bwd_ref`` at
   8192 x 2048, 1000 x 2560 and 1000 x 5120 in bf16 (dx at one bf16 ulp,
   dgain at one ulp and, from an fp32 gain, by ``RMS_DGAIN_REL_NORM``) and
   33 x 128 in fp32, two launches bit-equal;
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
6. parity: reduced tinyllama-1.1b trains 3 steps from the same weights on
   the same batches on the card and on the CPU; losses, final params and
   step-1 gradients must agree within ``TRAIN_*_RTOL``;
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
   the card's mesh are printed (host arithmetic).

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

A kernel's ``launches`` in the JSON record is its count over the serve
(phases 3, 7, 8, 11) and train (phase 5) runs; K3's are also printed by
shape class; the ``*_d256`` records count phase 11's runs only.
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
    for rec in records:
        rec["launches"] = launches.get(rec["name"])
    print(f"[launches] rmsnorm by shape class over the main paths: "
          f"{RMS_LAUNCHES} (decode: a decode step's; prefill: a prompt's "
          f"or chunk's; train: 8192 rows)", flush=True)
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


def compare(torch, name, got, want, atol, rtol, gate=True):
    """Elementwise |got - want| <= atol + rtol |want|; fails unless
    ``gate`` is False (then the worst err/tol is printed for information).
    Returns the max abs error."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output not finite")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-6)).max())
    used = float((err / (atol + rtol * want.abs())).max())
    ok = used <= 1.0
    verdict = ("ok" if ok else "FAIL") if gate else "not gated"
    print(f"[kernel] {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"tol=atol {atol:g} + rtol {rtol:g}*|ref|, worst err/tol="
          f"{used:.3f} -> {verdict}", flush=True)
    if gate and not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs


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
        errs.append(compare(torch, f"paged_attention {label}", got, want,
                            *tol[dtype]))
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
    records += check_dense_kernels(torch, randn, tol)
    records += check_head_dim_256(torch, randn, tol)
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
# heads a decode step, 2048 tokens x 16 heads a prompt), and a training
# norm's 8192 rows of 2048 (B=2 x S=4096)
RMS_CLASSES = ([("decode", 8, d) for d in (2048, 2560, 4096, 5120, 3840)]
               + [("decode", 128, 256)]
               + [("prefill", 1000, d) for d in (2048, 2560, 4096, 5120)]
               + [("prefill", 2048, 3840), ("prefill", 32768, 256)]
               + [("train", 8192, 2048)])
# K3's launches on the main paths by shape class, summed by phases 3, 5,
# 7, 8 and 11
RMS_LAUNCHES = {"decode": 0, "prefill": 0, "train": 0}
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


def check_rmsnorm(torch, randn, tol):
    """K3's forward against ``rmsnorm_ref`` over the paths' shapes, and its
    backward against ``rmsnorm_bwd_ref``: dx elementwise (both fp32 from
    the same inputs, rounded once: one bf16 ulp), dgain elementwise in the
    gain's bf16 and, from an fp32 copy of the same gain, by relative norm
    (``RMS_DGAIN_REL_NORM``); two backward launches bit-equal.  Timed at
    every shape class.  Returns the forward's and the backward's records."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rms
    bf16, f32 = torch.bfloat16, torch.float32
    errs = []
    # 8192 rows of 2048: a norm of the training path (B=2 x S=4096)
    # 1000 and 8 rows of 2560 (zamba2), 5120 (its Mamba-2 inner norm) and
    # 4096 (rwkv6): a ragged prefill and a decode step of the dense path,
    # 2560 and 5120 through the kernel's masked tail; gemma3-12b's 3840
    # (a 2048-token prompt, a decode step) and its q_norm/k_norm over
    # 256-wide heads (2048 tokens x 16 heads, 8 lanes x 16 heads)
    for rows, d, dtype in ((33, 128, f32), (8, 64, bf16), (8, 2048, bf16),
                           (512, 2048, bf16), (8192, 2048, bf16),
                           (1000, 2560, bf16), (8, 2560, bf16),
                           (1000, 5120, bf16), (8, 5120, bf16),
                           (1000, 4096, bf16), (8, 4096, bf16),
                           (2048, 3840, bf16), (8, 3840, bf16),
                           (32768, 256, bf16), (128, 256, bf16)):
        x, g = randn(rows, d, dtype=dtype), randn(d, dtype=f32, scale=0.1)
        errs.append(compare(torch, f"rmsnorm rows={rows} d={d} {dtype}",
                            rms.rmsnorm(x, g), rms.rmsnorm_ref(x, g),
                            *tol[dtype]))
    fwd = dict(name="rmsnorm", route="triton",
               source="src/repro_torch/kernels/rmsnorm.py",
               replaces="src/repro/kernels/rmsnorm.py:24",
               max_abs_err=max(errs), shape="x (8192, 2048) bf16")
    fwd.update(time_rmsnorm_classes(torch, rms, torch.Generator(
        device="cuda").manual_seed(11)))

    errs = []
    for rows, d, dtype in ((8192, 2048, bf16), (1000, 2560, bf16),
                           (1000, 5120, bf16), (33, 128, f32)):
        x, dy = randn(rows, d, dtype=dtype), randn(rows, d, dtype=dtype)
        g = randn(d, dtype=dtype, scale=0.1)
        label = f"rows={rows} d={d} {dtype}"
        dx, dg = rms.rmsnorm_bwd(dy, x, g)
        want_dx, want_dg = rms.rmsnorm_bwd_ref(dy, x, g)
        errs.append(compare(torch, f"rmsnorm_bwd dx {label}", dx, want_dx,
                            *tol[dtype]))
        compare(torch, f"rmsnorm_bwd dgain {label}", dg, want_dg, *tol[dtype])
        if dtype == bf16:
            g32 = g.float()
            rel_norm(torch, f"rmsnorm_bwd dgain {label}, fp32 gain",
                     rms.rmsnorm_bwd(dy, x, g32)[1],
                     rms.rmsnorm_bwd_ref(dy, x, g32)[1], RMS_DGAIN_REL_NORM)
        if rows == 8192:
            same_twice(torch, f"rmsnorm_bwd {label}",
                       lambda: rms.rmsnorm_bwd(dy, x, g))
            ms = timed_ms(torch, lambda: rms.rmsnorm_bwd(dy, x, g))
            kernel_split(torch, lambda: rms.rmsnorm_bwd(dy, x, g),
                         f"rmsnorm_bwd {label}")
            plain = timed_ms(torch, lambda: rms.rmsnorm_bwd_ref(dy, x, g),
                             iters=3, reps=3)
            xl, gl = x.clone().requires_grad_(True), \
                g.clone().requires_grad_(True)
            yl = F.rms_norm(xl, (d,), weight=1.0 + gl, eps=1e-6)
            lib = timed_ms(torch, lambda: torch.autograd.grad(
                yl, (xl, gl), dy, retain_graph=True))
            del xl, gl, yl
            b_ms, b_by = rms_bound(rows, d, 2, 3, 2, 12)
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
            1e-5)
    if q.dtype == torch.float32:
        return compare(torch, name, o, o_f, *tol[torch.float32]), o, lse
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


def time_fwd_d80(torch, q, k, v):
    """K2 at zamba2's prefill shape (head dim 80): one ``[time]`` line."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_ref)
    b, h, sq, d = q.shape
    ms = timed_ms(torch, lambda: flash_attention_fwd(q, k, v))
    plain = timed_ms(torch, lambda: flash_attention_fwd_ref(
        q, k, v, operand_dtype=torch.bfloat16))
    lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    pairs = b * h * sq * (sq + 1) // 2
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * h * sq
    b_ms, b_by = bound(nbytes, 4 * d * pairs, H100_BF16_FLOPS)
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
    import torch.nn.functional as F
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
                            *tol[dtype]))
        for i, n in enumerate(vlens):
            if n == 0 and float(got[i].abs().max()) != 0.0:
                fail("decode_attention: a lane of valid length 0 must "
                     "return zeros")
        timed[label.split()[0]] = (q, k, v, vlen)
    same_twice(torch, "decode_attention zamba2 G=1",
               lambda: (decode_attention(q, k, v, vlen),))

    def times(q, k, v, vlen):
        b, kvh, s, d = k.shape
        h = q.shape[1]
        ms = timed_ms(torch, lambda: decode_attention(q, k, v, vlen))
        plain = timed_ms(torch, lambda: decode_attention_ref(q, k, v, vlen))
        mask = (torch.arange(s, device=dev)[None, :] < vlen[:, None])
        lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask[:, None, None],
            enable_gqa=True))
        attended = int(vlen.clamp(max=s).sum())
        nbytes = (2 * q.numel() * 2 + vlen.numel() * 4
                  + 2 * attended * kvh * d * 2)
        b_ms, b_by = bound(nbytes, 4 * h * d * attended, H100_BF16_FLOPS)
        return ms, plain, lib, b_ms, b_by

    ms, plain, lib, b_ms, b_by = times(*timed["tinyllama"])
    print(f"[time] decode_attention at tinyllama's G=8 shape (B=8 H=32 KV=4 "
          f"D=64 S=2048, vlen 120-2048): kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, library {lib:.4f} ms (SDPA, length mask), bound "
          f"{b_ms:.4f} ms ({b_by}), share of bound {b_ms / ms:.3f}",
          flush=True)
    # the record: zamba2's decode shape (last case), every lane at the
    # shared position 896 of the serve run's longest prompt, cache 2048
    ms, plain, lib, b_ms, b_by = times(q, k, v, vlen)
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
                                         vl4), *tol[bf16])]
    ragged = torch.tensor([1024, 1, 0, 500, 1000, 129, 700, 1029],
                          dtype=torch.int32, device=dev)
    errs.append(compare(torch, "decode_attention d=256 lengths 0-1029",
                        decode_attention(q4, k4, v4, ragged),
                        decode_attention_ref(q4.float(), k4.float(),
                                             v4.float(), ragged),
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
        errs.append(compare(torch, f"ssd_scan y {label}", y, y_r, 1e-4, 1e-4))
        compare(torch, f"ssd_scan state {label}", st, st_r, 1e-4, 1e-4)
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
                            1e-4))
        compare(torch, f"rwkv6_wkv state {label}", st, st_r, 1e-4, 1e-4)
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
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_dkv_ref, flash_attention_dq_ref, flash_attention_fwd,
        flash_attention_fwd_ref)
    bf16, f32 = torch.bfloat16, torch.float32
    # the forward at six head dims, the backward's dQ and dK/dV at four
    tensor_core_sass({"flash_attention_fwd": 6, "flash_attention_bwd": 8})
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
        # q and dO rows 4 elements apart from 16-byte alignment: the
        # wrappers copy them for the kernels' cp.async
        ("d=32 non-causal GQA sq=100 sk=300 h=4/1 unaligned q/dO", 1, 4, 1,
         100, 300, 32, False, 0, 0, bf16),
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
                1e-4, 1e-5)
        name = f"flash_attention_bwd {{}} {label}"
        if dtype == f32:
            errs["dq"].append(compare(torch, name.format("dq"), dq, dq_r,
                                      *tol[dtype]))
            dk_r, dv_r = flash_attention_dkv_ref(q, k, v, lse, delta_r, do,
                                                 **kw)
            errs["dkv"].append(max(
                compare(torch, name.format("dk"), dk, dk_r, *tol[dtype]),
                compare(torch, name.format("dv"), dv, dv_r, *tol[dtype])))
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


def step_grads(torch, model, plan, params, batch):
    """The gradients one train step takes (``make_train_step``'s
    arithmetic: microbatch i takes rows i::mb, fp32 sums divided by mb),
    computed here with ``model.loss_fn`` and autograd -> a list of fp32
    tensors in the params' leaf order."""
    from repro_torch.training.optimizer import leaves, tree_map
    mb = max(plan.microbatch, 1)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves(params)]
    for i in range(mb):
        tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = model.loss_fn(tracked, {k: v[i::mb]
                                          for k, v in batch.items()})
        for a, g in zip(acc, torch.autograd.grad(loss, leaves(tracked))):
            a.add_(g)
    return [a.div_(mb) for a in acc]


def _train_kernels():
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq,
                                                     flash_attention_fwd)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "rmsnorm": rmsnorm, "rmsnorm_bwd": rmsnorm_bwd}


# ---------------------------------------------------------------------------
# phase 5: full-width tinyllama-1.1b training
# ---------------------------------------------------------------------------

def train_full(torch):
    """tinyllama-1.1b at full width (random weights from seed 0), sequence
    4096 with the global batch cut from 256 to 8, 4 microbatches of 2
    under full remat (``overrides`` on the ladder's plan), 4 AdamW steps,
    through ``Cluster.submit``.  Prints the ladder's own plan and its
    estimate beside the measured peak.  Returns the launch counts."""
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.core.materializer import H100, materialize
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import train
    from repro_torch.models.model import Model, init_params
    from repro_torch.training.train_step import impl_from_plan
    kernels = _train_kernels()
    shape, overrides, ocfg, steps = _train_setup()
    cfg = get_config("tinyllama-1.1b")
    plan = materialize(cfg, shape, H100, overrides=overrides)
    ladder = materialize(cfg, shape, H100)

    # step 1's gradients: train() below starts from init_params(cfg, 0)
    # and the data's batch 0
    params = init_params(cfg, 0, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        DataConfig(cfg.vocab_size, shape.seq_len, shape.global_batch))
        .batch_at(0).items()}
    grads = step_grads(torch, Model(cfg, impl_from_plan(plan)), plan, params,
                       batch)
    bad = [key for (key, _), g in zip(_flatten_with_paths(params), grads)
           if not bool(torch.isfinite(g).all()) or not bool(g.any())]
    checked = len(grads)
    del params, batch, grads
    if bad:
        fail(f"train: step 1 gradients of {bad} (of {checked} leaves) are "
             "not finite or all zero")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for fn in kernels.values():
        fn.launches = 0
    with row_copies() as seen:
        out = train("tinyllama-1.1b", shape=shape, overrides=overrides,
                    opt_cfg=ocfg, device="cuda", steps=steps, seed=0)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    no_row_copies("train", seen)
    peak = torch.cuda.max_memory_allocated()
    if out["plan"].describe() != plan.describe():
        fail(f"train: the cluster's plan {out['plan'].describe()} is not "
             f"the ladder's with {overrides}")
    print(f"[train] the ladder's own plan for {shape.name}: remat="
          f"{ladder.remat} microbatch={ladder.microbatch} est "
          f"{ladder.est_bytes_per_device / 2**30:.3f} GiB/device "
          f"({ladder.notes}); the run's plan (overrides {overrides}): est "
          f"{plan.est_bytes_per_device / 2**30:.3f} GiB/device, measured "
          f"peak {peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated); "
          f"the job's grant {out['grant'] / 2**30:.3f} GiB over "
          f"{out['held'] / 2**30:.3f} GiB held ("
          f"{base / 2**30:.3f} GiB allocated before) | {card_line()}",
          flush=True)
    if not out["grant"] >= out["held"] >= peak - base:
        fail(f"train: the job's grant {out['grant']} does not cover the "
             f"measured peak {peak} ({out['held']} held)")
    losses = [m["loss"] for m in out["metrics"]]
    n_layers, mb = cfg.num_layers, plan.microbatch
    per_mb = {"flash_attention_fwd": 2 * n_layers,      # forward + recompute
              "flash_attention_bwd_dq": n_layers,
              "flash_attention_bwd_dkv": n_layers,
              "rmsnorm": 2 * (2 * n_layers) + 1,        # ln_f not recomputed
              "rmsnorm_bwd": 2 * n_layers + 1}
    want = {k: v * mb * steps for k, v in per_mb.items()}
    print(f"[train] tinyllama-1.1b full width, seq {shape.seq_len} x batch "
          f"{shape.global_batch}, remat={plan.remat} microbatch="
          f"{plan.microbatch}, losses {losses}, launches="
          f"{launches} expected={want}, step-1 gradients finite and "
          f"nonzero on all {checked} leaves", flush=True)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"train: losses {losses} not finite or not decreasing")
    if launches != want:
        fail("train: kernel launch counts differ from what the path implies")
    RMS_LAUNCHES["train"] += launches["rmsnorm"]
    report_train(torch, out, peak, ocfg)
    del out
    torch.cuda.empty_cache()
    return launches


def _train_setup():
    """Phase 5's run: sequence 4096, global batch 8 in 4 microbatches under
    full remat, AdamW with one warmup step, 4 steps -> (shape, plan
    overrides, optimizer config, steps)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.training.optimizer import OptimizerConfig
    return (ShapeConfig("train_4k_b8", "train", 4096, 8),
            {"remat": "full", "microbatch": 4},
            OptimizerConfig(warmup_steps=1), 4)


def report_train(torch, out, peak, ocfg):
    """The step time (median of steps 2 on), tokens/s, peak memory and the
    model-FLOPs share of a ``train`` run; then one more step under
    ``torch.profiler``."""
    from repro_torch.training.optimizer import leaves
    shape, cfg, steps = out["shape"], out["model"].cfg, len(out["metrics"])
    n_layers = cfg.num_layers
    walls = sorted(m["wall_s"] for m in out["metrics"][1:])
    step_s = walls[len(walls) // 2]
    tokens = shape.seq_len * shape.global_batch
    params = out["params"]
    n_matmul = sum(p.numel() for p in leaves(params)) - \
        params["embed"]["tok"].numel()            # the embedding is a gather
    attn_flops = (3 * 2 * 2 * cfg.head_dim * cfg.num_heads * n_layers
                  * shape.global_batch * shape.seq_len * (shape.seq_len + 1)
                  / 2)                            # causal pairs, fwd + bwd
    model_flops = 6 * n_matmul * tokens + attn_flops
    print(f"[train] step {step_s:.4f} s (median of steps 2-{steps}; all "
          f"{[round(m['wall_s'], 4) for m in out['metrics']]}), "
          f"{tokens / step_s:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB, model FLOPs {model_flops:.4e} per step "
          f"= {model_flops / step_s / H100_BF16_FLOPS:.4f} of the bf16 peak "
          f"| {card_line()}", flush=True)
    busy = profile_train(torch, out, ocfg)
    # the profiled step's wall carries the profiler's host overhead, which
    # varies from run to run; the device time against the unprofiled step
    # does not
    if busy is not None:
        print(f"[train] device busy {busy:.3f} ms of the profiled step / "
              f"unprofiled step {step_s * 1e3:.3f} ms = busy share "
              f"{busy / (step_s * 1e3):.4f}", flush=True)


def profile_train(torch, out, ocfg):
    """One more step of the run above under ``torch.profiler``: the
    device's busy share and device time by kernel; returns the device
    busy ms."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.training.train_step import make_train_step
    shape, cfg = out["shape"], out["model"].cfg
    step = make_train_step(out["model"], out["plan"], ocfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, shape.seq_len,
                                  shape.global_batch))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch_at(out["cursor"]).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = step(out["params"], out["opt_state"], batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return report_profile(prof, wall, "train 1 step")


def report_profile(prof, wall, what):
    """Busy share and device time by kernel of a profiled window; returns
    the device busy ms (None when not measured)."""
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
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
    bwd_us = max((getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0.0))
                  for e in prof.key_averages()
                  if "RMSNormBackward" in e.key), default=0.0)
    for name, us in (("K3 rmsnorm forward kernels", fwd_us),
                     ("K3 norm backward (under RMSNormBackward)", bwd_us)):
        if us:
            print(f"[profile]   {us / 1e3:10.3f} ms  "
                  f"{100 * us / 1e3 / total_ms:5.1f}%  {name}", flush=True)
    # K6 and K7 run as three CUDA kernels a call each
    for name, mark in (("K7 ssd_scan", "ssd_"), ("K6 rwkv6_wkv", "wkv_")):
        us = sum(t for key, t in dev_us.items() if mark in key)
        if us:
            print(f"[profile]   {us / 1e3:10.3f} ms  "
                  f"{100 * us / 1e3 / total_ms:5.1f}%  {name}, all its "
                  "kernels", flush=True)
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
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.core.materializer import H100, Plan
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model, init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import impl_from_plan, make_train_step

    cfg = reduced_config(get_config("tinyllama-1.1b"), num_layers=2)
    plan = Plan(cfg.name, "reduced_160", H100, microbatch=2, remat="full")
    model = Model(cfg, impl_from_plan(plan))
    params0 = init_params(cfg, 0, "cpu")
    # sequence 160: ragged over the kernels' 64-row tiles
    data = SyntheticLM(DataConfig(cfg.vocab_size, 160, 8))
    ocfg = opt.OptimizerConfig(warmup_steps=1)

    def run(device):
        step = make_train_step(model, plan, ocfg)
        params = _tree_to(params0, device)
        state = opt.init_opt_state(params)
        losses, grads = [], None
        for i in range(3):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch_at(i).items()}
            if grads is None:
                grads = [g.cpu() for g in step_grads(torch, model, plan,
                                                     params, batch)]
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        return losses, _tree_to(params, "cpu"), grads

    cuda_losses, cuda_params, cuda_grads = run("cuda")
    cpu_losses, cpu_params, cpu_grads = run("cpu")
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
    print(f"[parity] reduced tinyllama-1.1b training cuda vs cpu, 3 steps: "
          f"losses {cuda_losses} vs {cpu_losses} (max rel {loss_err:.3e} <= "
          f"{TRAIN_LOSS_RTOL}), params rel norm {param_err:.3e} <= "
          f"{TRAIN_PARAM_RTOL}, step-1 grads worst rel norm "
          f"{grad_errs[worst]:.3e} ({worst}) <= {TRAIN_GRAD_RTOL}",
          flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_RTOL
            and grad_errs[worst] <= TRAIN_GRAD_RTOL):
        fail("parity: CUDA training disagrees with the CPU's plain path")


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
    in each attention block or shared-attention application, K7 in each
    Mamba-2 block and K6 in each RWKV-6 block; per decode step K4 in each
    attention block or application."""
    from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL,
                                          ATTN_SHARED, MAMBA2, RWKV6)
    nb = cfg.num_blocks
    count = {k: nb * cfg.pattern.count(k) for k in (MAMBA2, RWKV6,
                                                    ATTN_SHARED, ATTN_GLOBAL,
                                                    ATTN_LOCAL)}
    attn = count[ATTN_GLOBAL] + count[ATTN_LOCAL]
    qk = 2 if cfg.use_qk_norm else 0
    norms = (2 * count[MAMBA2] + 2 * count[RWKV6]
             + (3 + qk) * count[ATTN_SHARED] + (2 + qk) * attn + 1)
    return {"flash_attention_fwd": (count[ATTN_SHARED] + attn) * prefills,
            "rmsnorm": norms * (prefills + decode_steps),
            "decode_attention": (count[ATTN_SHARED] + attn) * decode_steps,
            "ssd_scan": count[MAMBA2] * prefills,
            "rwkv6_wkv": count[RWKV6] * prefills,
            "paged_attention": 0}


def serve_dense_full(torch, arch):
    """``arch`` at full width (random weights from seed 0) through
    ``serve(backend="dense")``: 8 requests, prompts 64..1024 (seed 0), 32
    new tokens, max batch 8, a 2048-token cache per slot.  Returns the launch counts of
    the kernels this path runs; then a profiled run of the same traffic
    with 8 new tokens on the same runner."""
    import gc
    from repro_torch.launch.serve import serve
    kernels = _dense_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with row_copies() as seen:
        out = serve(arch, backend="dense", device="cuda", requests=8,
                    max_batch=8, prompt_range=(64, 1024), max_new=32, seed=0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    no_row_copies(f"serve {arch}", seen)
    stats, runner, reqs = out["stats"], out["runner"], out["requests"]
    cfg = runner.cfg
    for r in reqs:
        toks = r.output_tokens or []
        if len(toks) != 33 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"serve {arch}: {r.req_id} returned {len(toks)} tokens "
                 f"(expected 1 + 32 in [0, {cfg.vocab_size}))")
    want = _expected_dense(cfg, stats.prefills, stats.decode_steps)
    print(f"[serve] {arch} full width, dense, prompts "
          f"{[r.prompt_len for r in reqs]}, prefills={stats.prefills} "
          f"decode_steps={stats.decode_steps} launches={launches} "
          f"expected={want}", flush=True)
    if launches != want or not all(n for name, n in launches.items()
                                   if want[name]):
        fail(f"serve {arch}: kernel launch counts differ from what the "
             "path implies")
    norms = want["rmsnorm"] // (stats.prefills + stats.decode_steps)
    RMS_LAUNCHES["prefill"] += norms * stats.prefills
    RMS_LAUNCHES["decode"] += norms * stats.decode_steps
    print(f"[serve] {arch} mean_ttft={stats.mean_ttft_s * 1e3:.3f} ms "
          f"mean_decode_step={stats.mean_decode_step_s * 1e3:.3f} ms "
          f"tokens/s={stats.tokens_generated / stats.wall_s:.2f} "
          f"wall={wall:.3f} s (weights init included) peak_mem="
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | "
          f"{card_line()}", flush=True)
    profile_dense(torch, arch, runner)
    del out, runner, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return {name: n for name, n in launches.items() if want[name]}


def profile_dense(torch, arch, runner):
    """The phase's traffic with 8 new tokens, on the same runner, under
    ``torch.profiler``: busy share and device time by kernel."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PagePool, Request
    rng = np.random.default_rng(0)
    reqs = [Request(f"r{i}", int(rng.integers(64, 1025)), 8)
            for i in range(8)]
    eng = ServingEngine(PagePool(128), max_batch=8, runner=runner)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        stats = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, f"{arch} dense serve 8 req x 8 new "
                               f"(decode_steps {stats.decode_steps})")


# ---------------------------------------------------------------------------
# phase 9: reduced dense serving, CUDA against CPU, same weights and prompts
# ---------------------------------------------------------------------------

def parity_dense_reduced(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kv_cache import PagePool, Request
    from repro_torch.serving.model_runner import DenseRunner
    lens = [200, 9, 77, 130]
    for arch in ("zamba2-2.7b", "rwkv6-7b", "tinyllama-1.1b"):
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


if __name__ == "__main__":
    main()
