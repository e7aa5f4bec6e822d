#!/usr/bin/env python3
"""Drive the PyTorch/Hopper port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, on one card

Phases, each of which must pass (any failure exits nonzero):

1. build: every CUDA source under ``src/repro_torch/csrc`` is compiled by
   ``nvcc`` for ``sm_90a`` (one process per source, all together) and the
   Triton RMSNorm is compiled on its first call;
2. kernels: each hand-written kernel, on the card, at a small shape and at
   the tinyllama-1.1b shapes of the serving path, is held against its plain
   PyTorch version on the same inputs within the stated tolerance, and
   timed beside the plain version and one PyTorch library call computing
   the same function (the port itself never calls those);
3. serve: full-width tinyllama-1.1b (random weights from seed 0) serves 8
   requests with prompts of 64..1024 tokens (native and chunked prefill)
   and 32 new tokens each through the port's engine; every request must
   complete and every kernel's launch count must equal what the path
   implies (counts are zeroed just before and read just after); then the
   same serve, 8 new tokens each, under ``torch.profiler`` gives the
   device's busy share and the device time by kernel;
4. parity: reduced tinyllama-1.1b serves the same prompts with the same
   weights on the card and on the CPU (the plain versions) in this process;
   the greedy tokens must be equal except where the CPU run's top-2 logit
   gap is below ``TIE_GAP`` (then that request stops being compared).

The second-to-last lines are the kernels' JSON record and the card's name
and power limit; the last line is the run's JSON verdict.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    print(f"[build] nvcc {sorted(reports) or 'cached'} "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    records = check_kernels(torch)
    launches = serve_full(torch)
    profile_serve(torch)
    parity_reduced(torch)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
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


def compare(torch, name, got, want, atol, rtol):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output not finite")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-6)).max())
    used = float((err / (atol + rtol * want.abs())).max())
    ok = used <= 1.0
    print(f"[kernel] {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"tol=atol {atol:g} + rtol {rtol:g}*|ref|, worst err/tol="
          f"{used:.3f} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch):
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_ref)
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_ref)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
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

    # -- K3 rmsnorm ---------------------------------------------------------
    errs = []
    for rows, d, dtype in ((33, 128, f32), (8, 64, bf16), (8, 2048, bf16),
                           (512, 2048, bf16)):
        x, g = randn(rows, d, dtype=dtype), randn(d, dtype=f32, scale=0.1)
        errs.append(compare(torch, f"rmsnorm rows={rows} d={d} {dtype}",
                            rmsnorm(x, g), rmsnorm_ref(x, g), *tol[dtype]))
    x, g = randn(512, 2048), randn(2048, scale=0.1)
    ms = timed_ms(torch, lambda: rmsnorm(x, g))
    plain = timed_ms(torch, lambda: rmsnorm_ref(x, g))
    w = 1.0 + g
    lib = timed_ms(torch, lambda: F.rms_norm(x, (2048,), weight=w, eps=1e-6))
    b_ms, b_by = bound(2 * x.numel() * 2 + g.numel() * 2, 4 * x.numel(),
                       H100_FP32_FLOPS)
    records.append(dict(name="rmsnorm", route="triton",
                        source="src/repro_torch/kernels/rmsnorm.py",
                        replaces="src/repro/kernels/rmsnorm.py:24",
                        max_abs_err=max(errs), ms=ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                        shape="x (512, 2048) bf16"))

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
    # held against the plain version on fp32 copies of the same inputs:
    # the plain version rounds scores and probs to bf16 as the reference
    # does, the kernel keeps them in fp32 and rounds its output once
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
        ("tinyllama native s=512 h=32/4 d=64", 1, 32, 4, 512, 512, 64, True,
         0, 0, bf16),
        ("tinyllama chunk q_offset=512 sq=512 sk=1024", 1, 32, 4, 512, 1024,
         64, True, 0, 512, bf16),
    ]
    for (label, b, h, kvh, sq, sk, d, causal, window, off, dtype) in fcases:
        q = randn(b, sq, h, d, dtype=dtype).transpose(1, 2)   # model layout
        k = randn(b, sk, kvh, d, dtype=dtype).transpose(1, 2)
        v = randn(b, sk, kvh, d, dtype=dtype).transpose(1, 2)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     q_offset=off)
        o_ref, lse_ref = flash_attention_fwd_ref(
            q.float(), k.float(), v.float(), causal=causal, window=window,
            q_offset=off)
        errs.append(compare(torch, f"flash_attention_fwd o {label}", o,
                            o_ref, *tol[dtype]))
        compare(torch, f"flash_attention_fwd lse {label}", lse, lse_ref,
                1e-4, 1e-5)
    # timed at the chunked-prefill shape of the serving run (last case)
    ms = timed_ms(torch, lambda: flash_attention_fwd(q, k, v, q_offset=off))
    plain = timed_ms(torch, lambda: flash_attention_fwd_ref(q, k, v,
                                                            q_offset=off))
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
                              f"q_offset={off} causal"))
    for rec in records:
        print(f"[time] {rec['name']} ({rec['shape']}): kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
              f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})", flush=True)
    return records


# ---------------------------------------------------------------------------
# phase 3: full-width tinyllama-1.1b through the engine
# ---------------------------------------------------------------------------

def serve_full(torch):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.launch.serve import serve
    kernels = {"paged_attention": paged_attention,
               "flash_attention_fwd": flash_attention_fwd,
               "rmsnorm": rmsnorm}
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = serve("tinyllama-1.1b", device="cuda", requests=8, max_batch=8,
                pool_pages=128, prompt_range=(64, 1024), max_new=32, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
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
    want = {"paged_attention": n_layers * stats.decode_steps,
            "flash_attention_fwd": n_layers * runner.prefill_chunks,
            "rmsnorm": (2 * n_layers * (runner.prefill_chunks
                                        + stats.decode_steps)
                        + stats.prefills + stats.decode_steps)}
    print(f"[serve] tinyllama-1.1b full width, prompts {lens}, "
          f"prefills={stats.prefills} chunks={runner.prefill_chunks} "
          f"decode_steps={stats.decode_steps} launches={launches} "
          f"expected={want}", flush=True)
    if launches != want or not all(launches.values()):
        fail("serve: kernel launch counts differ from what the path implies")
    print(f"[serve] mean_ttft={stats.mean_ttft_s * 1e3:.3f} ms "
          f"mean_decode_step={stats.mean_decode_step_s * 1e3:.3f} ms "
          f"tokens/s={stats.tokens_generated / stats.wall_s:.2f} "
          f"wall={wall:.3f} s peak_mem="
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    return launches


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
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
              for e in kernels}
    total_ms = sum(dev_us.values()) / 1e3
    if total_ms <= 0:
        print("[profile] device time not measured: the profiler recorded "
              "no CUDA kernel time", flush=True)
        return
    stats = out["stats"]
    print(f"[profile] serve 8 req x 8 new: wall {wall * 1e3:.3f} ms "
          f"(under the profiler), device busy {total_ms:.3f} ms, busy "
          f"share {total_ms / (wall * 1e3):.4f}, decode_steps "
          f"{stats.decode_steps}, prefill chunks "
          f"{out['runner'].prefill_chunks}", flush=True)
    for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   {us / 1e3:10.3f} ms  {100 * us / 1e3 / total_ms:5.1f}%"
              f"  {key[:90]}", flush=True)


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


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


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
