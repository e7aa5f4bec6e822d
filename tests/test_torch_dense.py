"""The port's dense serving slice against the JAX package's, on CPU.

K4 (decode attention) against the Pallas kernel interpreted on CPU and the
reference oracle; the dense attention functions, and the Mamba-2, RWKV-6
and zamba2 shared-attention blocks (prefill and decode) against the
reference's on bridged weights; and the slice as a whole: reduced zamba2
and tinyllama-1.1b served by the reference's ``DenseRunner`` and by the
port's, with prompts of 9 to 200 tokens mixed in one batch.  Greedy tokens
must be equal, except that a request may diverge at a step where the
port's top-2 logit gap is below ``TIE_GAP`` (the rule of
``test_torch_serving.py``: the two frameworks round bf16 at slightly
different places, which can flip a near-tie).

Tolerances: K4 as ``tests/test_kernels.py`` (fp32 2e-5, bf16 3e-2); the
layers and blocks as ``test_torch_models.py`` (fp32 2e-5, bf16 2e-2).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.kernels import ops, ref
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import transformer as jT
from repro.models.transformer import ImplConfig as JaxImpl
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.kv_cache import PagePool as JaxPool
from repro.serving.kv_cache import Request as JaxRequest
from repro.serving.model_runner import build_runner as jax_build_runner
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN_LOCAL
from repro_torch.configs.reduced import reduced_config
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tT
from repro_torch.models.model import Model, param_specs
from repro_torch.models.transformer import ImplConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import PagePool, Request
from repro_torch.serving.model_runner import DenseRunner, build_runner

KTOL = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=3e-2, atol=3e-2)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TIE_GAP = 1e-2


def pair(a, dtype="float32"):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a)
    a = a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    return jnp.asarray(a), tensor_from_numpy(a, torch.device("cpu"))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def cfgs(arch, **extra):
    return (jax_reduced(jax_get_config(arch), **extra),
            reduced_config(get_config(arch), **extra))


# ---------------------------------------------------------------------------
# K4 decode attention: the test_decode_attention sweep, plus D=80
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kvh,s,d,vlens", [
    (2, 4, 2, 256, 32, None), (1, 8, 8, 512, 64, None),
    (3, 6, 2, 128, 16, None),
    (3, 32, 32, 256, 80, (1, 77, 256)),    # zamba2's head dim, ragged lanes
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(b, h, kvh, s, d, vlens, dtype):
    rng = np.random.default_rng(b * h * s + d)
    qj, qt = pair(rng.standard_normal((b, h, d)), dtype)
    kj, kt = pair(rng.standard_normal((b, kvh, s, d)), dtype)
    vj, vt = pair(rng.standard_normal((b, kvh, s, d)), dtype)
    vl = np.asarray(vlens if vlens else rng.integers(1, s, size=(b,)),
                    np.int32)
    got = decode_attention(qt, kt, vt, torch.from_numpy(vl))
    close(got, ops.decode_attention(qj, kj, vj, jnp.asarray(vl), block_s=64),
          KTOL[dtype])
    close(got, ref.decode_attention_ref(qj, kj, vj, jnp.asarray(vl)),
          KTOL[dtype])


def test_gqa_decode_sdpa_matches_reference_rounding():
    """The model-level decode attention in bf16: the plain version follows
    the reference's rounding order, so the bf16 model tolerance holds."""
    rng = np.random.default_rng(2)
    qj, qt = pair(rng.standard_normal((2, 1, 8, 16)), "bfloat16")
    kj, kt = pair(rng.standard_normal((2, 2, 40, 16)), "bfloat16")
    vj, vt = pair(rng.standard_normal((2, 2, 40, 16)), "bfloat16")
    want = jattn.gqa_decode_sdpa(qj, kj, vj, jnp.arange(40) <= 30)
    close(tattn.gqa_decode_sdpa(qt, kt, vt, 31), want, TOL["bfloat16"])


# ---------------------------------------------------------------------------
# blocks on bridged weights: prefill, then one decode step
# ---------------------------------------------------------------------------

def _bridged(arch, seed=0):
    """Reduced configs, the reference's params with every leaf perturbed
    (nonzero norm gains too), as numpy and bridged into the port."""
    jcfg, tcfg = cfgs(arch)
    jparams = build_model(jcfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    host = jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.standard_normal(a.shape) * 0.05).astype(a.dtype),
        jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, host, params_from_jax(host, tcfg, "cpu")


@pytest.mark.parametrize("arch,index", [
    ("zamba2-2.7b", 0), ("zamba2-2.7b", 5), ("rwkv6-7b", 0)])
def test_block_prefill_and_decode_match_reference(arch, index):
    """One block of each kind (Mamba-2, the zamba2 shared-attention
    application, RWKV-6) through a 40-token prefill and a decode step at
    position 40: outputs and every decode-state leaf, the port's written
    in place into a zeroed cache.  The reference's RWKV-6 runs at
    ``scan_chunk=16`` (its chunk clamp does not bite within 16 tokens; see
    ``test_torch_scans.py``); the port's scans have no chunk knob."""
    jcfg, tcfg, host, tparams = _bridged(arch)
    kind = tcfg.pattern[index]
    key = f"p{index}_{kind}"
    jimpl = JaxImpl(remat="none", scan_chunk=16)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), host["blocks"][key])
    tp = jax.tree.map(lambda t: t[0], tparams["blocks"][key])
    jshared = {k: jax.tree.map(jnp.asarray, host[k])
               for k in ("shared_attn",) if k in host}
    tshared = {k: tparams[k] for k in ("shared_attn",) if k in tparams}
    rng = np.random.default_rng(index)
    s, cache_len = 40, 64
    xj, xt = pair(rng.standard_normal((2, s, tcfg.d_model)), "bfloat16")
    want, jcache = jT.apply_block_prefill(jcfg, jimpl, kind, jp, xj, jshared,
                                          None, cache_len)
    tcache = {leaf: torch.full(spec.shape, 7.0, dtype=spec.dtype)
              for leaf, spec in tT.block_cache_specs(tcfg, kind, 2,
                                                     cache_len).items()}
    got, tout = tT.apply_block_prefill(tcfg, kind, tp, xt, tshared, tcache)
    assert tout is tcache                       # written in place
    close(got, want, TOL["bfloat16"])
    assert set(tcache) == set(jcache)
    for leaf in jcache:
        close(tcache[leaf], jcache[leaf], TOL["bfloat16"])

    x1j, x1t = pair(rng.standard_normal((2, 1, tcfg.d_model)), "bfloat16")
    want, jnew = jT.apply_block_decode(jcfg, jimpl, kind, jp, x1j, jcache,
                                       jnp.asarray(s, jnp.int32), jshared)
    got, tnew = tT.apply_block_decode(tcfg, kind, tp, x1t, tcache, s,
                                      tshared)
    assert tnew is tcache                       # written in place
    close(got, want, TOL["bfloat16"])
    for leaf in jnew:
        close(tnew[leaf], jnew[leaf], TOL["bfloat16"])


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b"])
def test_param_tree_matches_reference_layout(arch):
    """Keys and shapes of the port's spec tree equal the reference's (the
    shared attention, ``ln_in``, ``mu``/``mu_c``, ``a_log``/``dt_bias``/
    ``d_skip`` leaves included), so the bridge is a plain copy."""
    jcfg, tcfg = cfgs(arch)
    from repro.models import layers as JL
    jshapes = jax.tree.map(lambda s: s.shape, build_model(jcfg).param_specs(),
                           is_leaf=JL.is_spec)
    tshapes = jax.tree.map(lambda s: s.shape, param_specs(tcfg),
                           is_leaf=lambda s: hasattr(s, "std"))
    assert jshapes == tshapes


# ---------------------------------------------------------------------------
# the slice: DenseRunner against the reference's, tokens
# ---------------------------------------------------------------------------

PROMPT_LENS = (9, 200, 77, 130)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, vocab, n))
            for n in PROMPT_LENS]


def _serve(engine_cls, pool_cls, req_cls, runner, prompts, max_new):
    eng = engine_cls(pool_cls(32, policy="fixed"), max_batch=4,
                     runner=runner)
    reqs = [req_cls(f"r{i}", len(p), max_new, prompt_tokens=p)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_to_completion(max_steps=500)
    return stats, {r.req_id: r.output_tokens for r in reqs}


def _check_tokens(want, got, margins):
    flips = 0
    for rid, w in want.items():
        assert got[rid] is not None and len(got[rid]) == len(w)
        for j, (a, b) in enumerate(zip(w, got[rid])):
            if a != b:
                gap = margins[rid][j]
                assert gap < TIE_GAP, (
                    f"{rid} token {j}: port {b} vs reference {a} at a "
                    f"top-2 logit gap of {gap:.3e} (>= {TIE_GAP})")
                flips += 1
                break
    assert flips <= 1, f"{flips} near-tie divergences in {len(want)} requests"


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "tinyllama-1.1b"])
def test_reduced_dense_serve_matches_reference_runner(arch):
    """The port's engine + DenseRunner against the reference's, on bridged
    weights: one batch of 4 requests with prompts of 9..200 tokens, so
    decode runs at the shared position of the longest."""
    jcfg, tcfg = cfgs(arch)
    jrunner = jax_build_runner("dense", jcfg, seed=0, max_batch=4,
                               cache_len=256)
    prompts = _prompts(tcfg.vocab_size)
    _, want = _serve(JaxEngine, JaxPool, JaxRequest, jrunner, prompts, 6)
    params = params_from_jax(jax.tree.map(np.asarray, jrunner.params), tcfg,
                             "cpu")
    runner = DenseRunner(tcfg, max_batch=4, cache_len=256, params=params,
                         device="cpu", record_margins=True)
    stats, got = _serve(ServingEngine, PagePool, Request, runner, prompts, 6)
    assert stats.completed == 4 and runner.slots == {}
    _check_tokens(want, got, runner.margins)


def test_reduced_rwkv6_dense_serve_matches_reference_at_chunk_16():
    """Reduced rwkv6 served by the port against the reference model built
    with ``ImplConfig(remat="none", scan_chunk=16)``, driven in the
    reference ``DenseRunner``'s order (its runner, with that model in place
    of its own: prefill per request, shared-``pos`` batched decode).  The
    reference's serving prefill at its default ``scan_chunk=128`` is
    unsound past about 30 tokens (its WKV clamp; see
    ``test_torch_scans.py``), so the reference is held at the chunk where
    its WKV is exact; the prompts are not shortened."""
    jcfg, tcfg = cfgs("rwkv6-7b")
    jrunner = jax_build_runner("dense", jcfg, seed=0, max_batch=4,
                               cache_len=256)
    jrunner.model = build_model(jcfg, JaxImpl(remat="none", scan_chunk=16))
    prompts = _prompts(tcfg.vocab_size, seed=1)
    _, want = _serve(JaxEngine, JaxPool, JaxRequest, jrunner, prompts, 6)
    params = params_from_jax(jax.tree.map(np.asarray, jrunner.params), tcfg,
                             "cpu")
    runner = DenseRunner(tcfg, max_batch=4, cache_len=256, params=params,
                         device="cpu", record_margins=True)
    stats, got = _serve(ServingEngine, PagePool, Request, runner, prompts, 6)
    assert stats.completed == 4
    _check_tokens(want, got, runner.margins)


def test_model_prefill_writes_the_slot_in_place():
    """``Model.prefill`` into a slot of a larger cache equals a prefill into
    its own cache, and leaves the other slots untouched."""
    _, tcfg = cfgs("zamba2-2.7b")
    model = Model(tcfg, ImplConfig(remat="none"))
    from repro_torch.models.model import init_params
    params = init_params(tcfg, 0, "cpu")
    toks = torch.randint(0, tcfg.vocab_size, (1, 21),
                         generator=torch.Generator().manual_seed(0))
    logits, own = model.prefill(params, toks, 32)
    big = model.init_cache(3, 32, "cpu")
    logits2, same = model.prefill(params, toks, 32, cache=big, slot=1)
    assert same is big and torch.equal(logits, logits2)
    for key, leaves in own.items():
        for leaf, t in leaves.items():
            assert torch.equal(big[key][leaf][:, 1], t[:, 0]), (key, leaf)
            assert not big[key][leaf][:, 0].any()
            assert not big[key][leaf][:, 2].any()


def test_dense_preemption_readmission_and_slot_eviction():
    """Prompt 200 = 2 pages; growth past token 256 in a full 8-page pool
    forces preemption and a re-prefill.  Completed requests own their
    tokens and leave no slot behind."""
    _, tcfg = cfgs("tinyllama-1.1b")
    runner = build_runner("dense", tcfg, max_batch=4, cache_len=320,
                          device="cpu")
    eng = ServingEngine(PagePool(8, policy="fixed"), max_batch=4,
                        runner=runner)
    reqs = [Request(f"r{i}", 200, 60) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_to_completion(max_steps=5000)
    assert stats.preempted >= 1, "scenario must exercise preemption"
    assert stats.completed == 4
    assert all(len(r.output_tokens) == 61 for r in reqs)
    assert runner.generated == {} and runner.slots == {}


def test_dense_refusals():
    _, tcfg = cfgs("tinyllama-1.1b")
    with pytest.raises(ValueError, match="prefix_cache"):
        build_runner("dense", tcfg, prefix_cache=object(), device="cpu")
    local = tcfg.scaled(pattern=(ATTN_LOCAL,), sliding_window=8)
    # a sliding-window stack serves now, from a ring of min(cache_len,
    # window) slots; a global layer's cache still bounds the position
    assert build_runner("dense", local, cache_len=320, device="cpu").cache[
        "p0_attn_local"]["k"].shape[3] == 8
    _, zcfg = cfgs("zamba2-2.7b")
    with pytest.raises(ValueError, match="dense"):
        build_runner("paged", zcfg, device="cpu")
    runner = build_runner("dense", tcfg, max_batch=1, cache_len=16,
                          device="cpu")
    eng = ServingEngine(PagePool(8, policy="fixed"), max_batch=1,
                        runner=runner)
    eng.submit(Request("long", 12, 8))
    with pytest.raises(ValueError, match="outside the dense cache"):
        eng.run_to_completion()
