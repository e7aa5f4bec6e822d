"""The port's sharded serving against the JAX package's, on the CPU.

The counterpart of ``tests/test_distributed.py``'s
``test_seqshard_decode_equals_unsharded`` and of the prefill and decode
cells ``launch/dryrun.py``'s ``lower_cell`` lowers under a plan of a
mesh.  The reference runs jitted over a (2, 2) mesh of 4 forced host
devices in a subprocess (as its own test does); the port runs on one
gloo world of 4 CPU processes laid out as ``h100x4``, (2, 2) over
('data', 'model') (``tests/torch_ranks.py``), each rank with its lanes
and its blocks of the weights and the dense cache:

* the sequence-sharded decode (reduced mistral-nemo-12b, B = 4, a
  12-token prompt, a cache of 32 positions laid out ``P(None, 'data',
  None, 'model', None)``, the reference's ``decode_shard_ctx``): 8 steps
  from position 12, across the ranks' block boundary at 16, from the
  one-process prefill's cache;
* TP prefill and decode under the ladder's ``decode_32k`` plan on
  ``h100x4`` (its batch of 128 cut to 4 lanes, its 32768 positions to
  64: a 56-token prompt and 8 steps) of reduced command-r-35b and
  gemma3-12b (five sliding-window layers whose rings of 8 slots wrap, and
  a global one);
* ``launch.serve`` through ``Cluster.submit`` on the dense backend, under
  weight-gathered (FSDP) plans too, and the refusals that remain
  (ROADMAP item A8d: the paged backend on a mesh, a world of another
  size, a long-context plan with FSDP).  The MoE, recurrent
  and vision-language families' sharded serving is
  ``tests/test_torch_sharded_families.py``'s.

Both sides decode the same fed tokens (numpy, seeded), so every step's
logits compare; each step's greedy token (the step's ``next``) must
equal the reference's but where the reference's top-2 gap is below
``TIE_GAP`` (the repo's CPU rule for the port against JAX).  Tolerances:
the reference test's own 5e-2 (bf16, logits and cache) against the
reference; 1e-5 in fp32 against the port's one-process steps.  K4's
log-sum-exp and the merge of partial softmax states are held on their
plain versions.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_paths
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.materializer import H100X4, Plan, materialize
from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                  decode_split_ref)
from repro_torch.launch.serve import serve
from repro_torch.models.model import Model, init_params
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ATTN_SHARED,
                                      DEC_ATTN, MAMBA2, MOE, RWKV6)
from repro_torch.models import transformer as T
from repro_torch.models.transformer import (ImplConfig, SERVE_MESH_KINDS,
                                            apply_block_decode)
from repro_torch.runtime import (Application, Cluster, ServeOptions,
                                 TorchExecutor)
from repro_torch.serving.model_runner import DenseRunner
from repro_torch.serving.serve_step import impl_from_plan, make_decode_step
from repro_torch.sharding.collectives import (TensorParallel,
                                              merge_softmax_parts)
from repro_torch.sharding.planner import P, ServeLayout, cache_specs_tree
from repro_torch.training import optimizer as topt
from torch_ranks import run_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TOL = 5e-2           # test_seqshard_decode_equals_unsharded's own
ONE_TOL = 1e-5           # fp32, against the port's one-process steps
TIE_GAP = 1e-2           # PERF.md section 2: the port against JAX on CPU
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# the reference test's setup, decoded 8 steps from 12: across the block
# boundary at 16 of a cache of 32 split over 'model'
SEQ = dict(arch="mistral-nemo-12b", batch=4, prompt=12, cache_len=32,
           steps=8)
SEQ_PLAN = dict(batch_axes=("data",), seq_axes=("model",), tp=False,
                zero=False, kv_shard_seq=True)
# decode_32k cut to 4 lanes of 64 positions: a 56-token prompt, 8 steps
TP_ARCHS = ("command-r-35b", "gemma3-12b")
TP_SHAPE = dataclasses.replace(SHAPES["decode_32k"], global_batch=4,
                               seq_len=64)
TP_PROMPT, TP_STEPS = 56, 8
SERVE = dict(arch="command-r-35b", requests=4, max_batch=4,
             prompt_range=(20, 60), max_new=6,
             # reduced dbrx-132b at widths whose experts, q heads,
             # embedding and head the planner's FSDP splits over 'data'
             dbrx=reduced_config(get_config("dbrx-132b"), d_model=256,
                                 num_heads=8, num_kv_heads=4, head_dim=32,
                                 vocab_size=512))
PLAN_FIELDS = ("batch_axes", "seq_axes", "tp", "ep", "fsdp", "zero",
               "remat", "attn_impl", "kv_shard_heads", "kv_shard_seq")

# the reference's side, in a process of 4 forced host devices: argv =
# inputs (.npz), cases (.json), output (.npz)
REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.reduced import reduced_config
from repro.core.materializer import MeshSpec, Plan
from repro.launch.dryrun import _model_impl
from repro.launch.mesh import _make_mesh
from repro.models import ImplConfig, build_model
from repro.serving.serve_step import make_decode_step, make_prefill_step
from repro.sharding import planner

inp = np.load(sys.argv[1])
cases = json.load(open(sys.argv[2]))
mesh = _make_mesh((2, 2), ("data", "model"))
spec = MeshSpec("h100x4", (2, 2), ("data", "model"))
out = {}


def params_of(case):
    tree, pre = {}, case + "/p/"
    for key in inp.files:
        if key.startswith(pre):
            node, *path = tree, *key[len(pre):].split("/")
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = jnp.asarray(inp[key], jnp.bfloat16)
    return tree


def keep_cache(prefix, cache):
    for key, leaf in cache.items():
        for name, a in leaf.items():
            out[f"{prefix}/{key}/{name}"] = np.asarray(a, np.float32)


c = cases["seqshard"]
cfg = reduced_config(get_config(c["arch"]))
params = params_of("seqshard")
m0 = build_model(cfg, ImplConfig(remat="none"))
_, cache = jax.jit(lambda p, b: m0.prefill(p, b, c["cache_len"]))(
    params, {"tokens": jnp.asarray(inp["seqshard/prompt"])})
m1 = build_model(cfg, ImplConfig(
    remat="none", decode_shard_ctx=(mesh, ("model",), ("data",))))
sh = jax.tree.map(
    lambda a: NamedSharding(mesh, P(None, "data", None, "model", None)), cache)
feed = inp["seqshard/feed"]
with mesh:
    cache = jax.tree.map(lambda a, s: jax.device_put(a, s), cache, sh)
    dec = jax.jit(m1.decode_step)
    for i in range(feed.shape[1]):
        lg, cache = dec(params, jnp.asarray(feed[:, i:i + 1]), cache,
                        jnp.asarray(c["pos"] + i, jnp.int32))
        out[f"seqshard/logits/{i}"] = np.asarray(lg, np.float32)
keep_cache("seqshard/cache", cache)

for arch, c in cases["tp"].items():
    cfg = reduced_config(get_config(arch))
    plan = Plan(arch, "decode_32k", spec, **{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in c["plan"].items()})
    params = params_of(arch)
    prompt, feed = inp[f"{arch}/prompt"], inp[f"{arch}/feed"]
    b, cl = prompt.shape[0], c["cache_len"]
    pm = build_model(cfg, _model_impl(plan, False, None, mesh))
    dm = build_model(cfg, _model_impl(plan, False, None, mesh,
                                      is_decode=True))
    p_sh = planner.to_named(
        planner.param_specs_tree(plan, cfg, pm.param_specs()), mesh)
    c_sh = planner.to_named(
        planner.cache_specs_tree(plan, cfg, pm.cache_specs(b, cl)), mesh)
    b_sh = NamedSharding(mesh, planner.batch_spec(plan, 1))
    with mesh:
        prefill = jax.jit(make_prefill_step(pm, cl),
                          in_shardings=(p_sh, {"tokens": b_sh}),
                          out_shardings=(None, c_sh))
        first, cache = prefill(params, {"tokens": jnp.asarray(prompt)})
        out[f"{arch}/first"] = np.asarray(first, np.float32)
        decode = jax.jit(make_decode_step(dm),
                         in_shardings=(p_sh, b_sh, c_sh,
                                       NamedSharding(mesh, P())),
                         out_shardings=(b_sh, None, c_sh))
        for i in range(feed.shape[1]):
            nxt, lg, cache = decode(params, jnp.asarray(feed[:, i:i + 1]),
                                    cache, jnp.asarray(prompt.shape[1] + i,
                                                       jnp.int32))
            out[f"{arch}/logits/{i}"] = np.asarray(lg, np.float32)
            out[f"{arch}/next/{i}"] = np.asarray(nxt)
    keep_cache(f"{arch}/cache", cache)
np.savez(sys.argv[3], **out)
"""


def _weights(cfg, rng):
    """Seed-0 weights with every leaf perturbed (nonzero norm gains too),
    bf16."""
    params = init_params(cfg, 0, "cpu")
    return topt.tree_map(lambda t: (t.float() + torch.from_numpy(
        rng.standard_normal(t.shape).astype(np.float32) * 0.05)).to(
            torch.bfloat16), params)


def _as(tree, dtype):
    return topt.tree_map(lambda t: t.to(dtype), tree)


def _one_decode(cfg, params, cache, feed, pos0):
    """The port's one-process decode over the fed tokens -> (logits
    (steps, B, 1, V), next tokens, cache)."""
    step, logits, nxt = make_decode_step(Model(cfg, ImplConfig(
        remat="none"))), [], []
    for j in range(feed.shape[1]):
        tok, lg, cache = step(params, feed[:, j:j + 1], cache, pos0 + j)
        logits.append(lg)
        nxt.append(tok)
    return torch.stack(logits), torch.stack(nxt), cache


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's runs (a subprocess with 4 forced host devices) and,
    beside them, the port's: the one-process prefills and fp32 decodes,
    then one gloo world of 4 ranks (``torch_ranks.sharded_serving``),
    then the one-process ``launch.serve``."""
    d = tmp_path_factory.mktemp("serving")
    rng = np.random.default_rng(0)
    inputs, ref_cases = {}, {"tp": {}}
    cases = {"seqshard": {}, "tp": {}, "serve": SERVE}
    one = {}

    cfg = reduced_config(get_config(SEQ["arch"]))
    params = _weights(cfg, rng)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SEQ["batch"], SEQ["prompt"])))
    feed = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SEQ["batch"], SEQ["steps"])))
    for path, t in _flatten_with_paths(params):
        inputs[f"seqshard/p/{path}"] = t.float().numpy()
    inputs["seqshard/prompt"] = prompt.int().numpy()
    inputs["seqshard/feed"] = feed.int().numpy()
    ref_cases["seqshard"] = {"arch": SEQ["arch"],
                             "cache_len": SEQ["cache_len"],
                             "pos": SEQ["prompt"]}
    for arch in TP_ARCHS:
        tcfg = reduced_config(get_config(arch))
        tparams = _weights(tcfg, rng)
        plan = materialize(tcfg, TP_SHAPE, H100X4)
        tprompt = torch.from_numpy(rng.integers(
            0, tcfg.vocab_size, (TP_SHAPE.global_batch, TP_PROMPT)))
        tfeed = torch.from_numpy(rng.integers(
            0, tcfg.vocab_size, (TP_SHAPE.global_batch, TP_STEPS)))
        for path, t in _flatten_with_paths(tparams):
            inputs[f"{arch}/p/{path}"] = t.float().numpy()
        inputs[f"{arch}/prompt"] = tprompt.int().numpy()
        inputs[f"{arch}/feed"] = tfeed.int().numpy()
        ref_cases["tp"][arch] = {
            "cache_len": TP_SHAPE.seq_len,
            "plan": {k: getattr(plan, k) for k in PLAN_FIELDS}}
        for dt, dtype in DTYPES.items():
            cases["tp"][f"{arch}/{dt}"] = {
                "cfg": tcfg, "plan": plan, "dtype": dtype,
                "params": _as(tparams, dtype), "prompt": tprompt,
                "feed": tfeed, "cache_len": TP_SHAPE.seq_len}
        p32 = _as(tparams, torch.float32)
        m = Model(tcfg, ImplConfig(remat="none"))
        cache = m.init_cache(TP_SHAPE.global_batch, TP_SHAPE.seq_len, "cpu",
                             torch.float32)
        first, cache = m.prefill(p32, tprompt, TP_SHAPE.seq_len, cache=cache)
        logits, nxt, cache = _one_decode(tcfg, p32, cache, tfeed, TP_PROMPT)
        one[arch] = {"first": first, "logits": logits, "next": nxt,
                     "cache": cache, "plan": plan}
    np.savez(d / "inputs.npz", **inputs)
    (d / "cases.json").write_text(json.dumps(ref_cases))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               TF_CPP_MIN_LOG_LEVEL="3", JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "inputs.npz"),
         str(d / "cases.json"), str(d / "reference.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    m = Model(cfg, ImplConfig(remat="none"))
    for dt, dtype in DTYPES.items():
        p = _as(params, dtype)
        cache = m.init_cache(SEQ["batch"], SEQ["cache_len"], "cpu", dtype)
        _, cache = m.prefill(p, prompt, SEQ["cache_len"], cache=cache)
        cases["seqshard"][dt] = {
            "cfg": cfg, "plan": Plan(cfg.name, "decode", H100X4, **SEQ_PLAN),
            "params": p, "cache": {k: {n: t.clone() for n, t in leaf.items()}
                                   for k, leaf in cache.items()},
            "feed": feed, "pos": SEQ["prompt"]}
        if dt == "fp32":
            logits, nxt, cache = _one_decode(cfg, p, cache, feed,
                                             SEQ["prompt"])
            one["seqshard"] = {"logits": logits, "next": nxt,
                               "cache": cache}
    torch.save(cases, d / "serving.pt")
    run_world("sharded_serving", 4, d)
    for key, arch in (("serve", SERVE["arch"]), ("dbrx", SERVE["dbrx"])):
        one[key] = serve(arch, backend="dense",
                         reduced=isinstance(arch, str), device="cpu",
                         requests=SERVE["requests"],
                         max_batch=SERVE["max_batch"],
                         prompt_range=SERVE["prompt_range"],
                         max_new=SERVE["max_new"], verbose=False)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-4000:]
    return {"reference": np.load(d / "reference.npz"), "one": one,
            "ranks": [torch.load(d / f"serving_{r}.pt", weights_only=False)
                      for r in range(4)]}


def _all_equal(ranks, get):
    """``get`` of every rank's output, which must be the same on all four
    (every rank returns every lane's logits and tokens)."""
    first = get(ranks[0])
    for r in ranks[1:]:
        assert torch.equal(get(r), first)
    return first


def _ref_stack(ref, prefix, n):
    return np.stack([ref[f"{prefix}/{i}"] for i in range(n)])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _caches_close(got, ref, prefix, tol):
    n = 0
    for key, leaf in got.items():
        for name, t in leaf.items():
            _close(t.float().numpy(), ref[f"{prefix}/{key}/{name}"], tol)
            n += 1
    assert n == len([k for k in ref.files if k.startswith(prefix + "/")])


def _greedy_agrees(next_tokens, ref_logits):
    """Each step's next token equal to the reference's argmax, but where
    the reference's top-2 gap is below ``TIE_GAP``; returns the count of
    such near-ties."""
    ref_logits = ref_logits[:, :, -1]                  # (steps, B, V)
    top = np.sort(ref_logits, axis=-1)
    ties = (top[..., -1] - top[..., -2]) < TIE_GAP
    want = ref_logits.argmax(-1)
    got = next_tokens[:, :, 0].numpy()
    assert ((got == want) | ties).all()
    return int(ties.sum())


def test_seqshard_decode_matches_the_reference(world):
    """The counterpart of ``test_seqshard_decode_equals_unsharded``, 8
    steps across the block boundary at 16: each step's logits and the
    final cache (gathered from the ranks' blocks) within the reference
    test's 5e-2 of the reference's sequence-sharded decode."""
    ref, ranks = world["reference"], world["ranks"]
    logits = _all_equal(ranks, lambda r: r["bf16"]["logits"])
    assert logits.shape == (SEQ["steps"], SEQ["batch"], 1, 256)
    _close(logits.float().numpy(),
           _ref_stack(ref, "seqshard/logits", SEQ["steps"]), REF_TOL)
    _caches_close(ranks[0]["bf16"]["cache"], ref, "seqshard/cache", REF_TOL)


def test_seqshard_decode_matches_one_process(world):
    """In fp32 the ranks' decode is the one-process decode within 1e-5:
    logits at every step and the whole cache.  Each rank held 2 of the 4
    lanes and 16 of the 32 positions, numbered as the reference numbers
    its blocks (data 0 the first lanes, model 0 the first positions)."""
    one, ranks = world["one"]["seqshard"], world["ranks"]
    logits = _all_equal(ranks, lambda r: r["fp32"]["logits"])
    _close(logits.numpy(), one["logits"].numpy(), ONE_TOL)
    for r, rank in enumerate(ranks):
        assert rank["fp32"]["lanes"] == (2, r // 2)
        assert rank["fp32"]["cache_shape"][1:4] == (2, 4, 16)
        for key, leaf in rank["fp32"]["cache"].items():
            for name, t in leaf.items():
                _close(t.numpy(), one["cache"][key][name].numpy(), ONE_TOL)
    # the block boundary was crossed: rows 16..19 written (model rank 1's
    # block), row 20 and on still empty
    k = one["cache"]["p0_attn_global"]["k"]
    assert k[:, :, :, 16:20].abs().amax() > 0
    assert k[:, :, :, 20:].abs().amax() == 0


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_serving_matches_the_reference(world, arch):
    """TP prefill and decode under the ladder's ``decode_32k`` plan on
    ``h100x4`` (TP, KV heads over 'model', the lanes over 'data', no
    FSDP), against the reference's ``make_prefill_step`` /
    ``make_decode_step`` jitted with the planner's shardings as
    ``lower_cell`` builds them: the prefill's and every step's logits
    within 5e-2, every step's greedy token equal under the ``TIE_GAP``
    rule, the final cache within 5e-2."""
    ref, ranks = world["reference"], world["ranks"]
    plan = world["one"][arch]["plan"]
    assert (plan.batch_axes, plan.tp, plan.kv_shard_heads, plan.fsdp,
            plan.seq_axes) == (("data",), True, True, False, ())
    name = f"{arch}/bf16"
    first = _all_equal(ranks, lambda r: r[name]["first"])
    _close(first.float().numpy(), ref[f"{arch}/first"], REF_TOL)
    logits = _all_equal(ranks, lambda r: r[name]["logits"]).float().numpy()
    want = _ref_stack(ref, f"{arch}/logits", TP_STEPS)
    _close(logits, want, REF_TOL)
    _greedy_agrees(_all_equal(ranks, lambda r: r[name]["next"]), want)
    _caches_close(ranks[0][name]["cache"], ref, f"{arch}/cache", REF_TOL)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_serving_matches_one_process(world, arch):
    """In fp32 the ranks' prefill, decode and cache are the one-process
    steps' within 1e-5; each rank held 2 of the 4 q heads and 2 of the 4
    KV heads."""
    one, ranks = world["one"][arch], world["ranks"]
    name = f"{arch}/fp32"
    _close(_all_equal(ranks, lambda r: r[name]["first"]).numpy(),
           one["first"].numpy(), ONE_TOL)
    _close(_all_equal(ranks, lambda r: r[name]["logits"]).numpy(),
           one["logits"].numpy(), ONE_TOL)
    assert torch.equal(_all_equal(ranks, lambda r: r[name]["next"]),
                       one["next"])
    for key, leaf in ranks[0][name]["cache"].items():
        for n, t in leaf.items():
            _close(t.numpy(), one["cache"][key][n].numpy(), ONE_TOL)
    for rank in ranks:
        assert rank[name]["wq"][2] == 2
        assert rank[name]["cache_k"][1:3] == (2, 2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k4_lse_on_the_plain_path(dtype):
    """K4's plain versions with ``return_lse``: the output in fp32 (the
    probabilities not rounded to the input dtype), within bf16's rounding
    of the output without lse (equal to it in fp32, and rounded, equal
    for the split mirror), and lse equal to ``torch.logsumexp`` of the
    masked, scaled scores each computes (``decode_attention_ref``'s
    products in the input dtype, as the reference rounds them;
    ``decode_split_ref``'s in fp32, as the kernel), -inf for a lane of
    valid length 0, whose output is 0."""
    rng = np.random.default_rng(3)
    b, h, kv, s, d = 4, 8, 2, 40, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(DTYPES[dtype])
        for shape in ((b, h, d), (b, kv, s, d), (b, kv, s, d)))
    vlen = torch.tensor([0, 1, 23, 45])
    ok = (torch.arange(s)[None, :] < vlen[:, None])[:, None, None]

    def lse_of(scores):
        return torch.logsumexp(torch.where(ok, scores * d ** -0.5,
                                           -torch.inf), -1).reshape(b, h)

    qg = q.reshape(b, kv, h // kv, d)
    out, lse = decode_attention_ref(q, k, v, vlen, return_lse=True)
    plain = decode_attention_ref(q, k, v, vlen)
    assert out.dtype == torch.float32
    if dtype == "fp32":
        assert torch.equal(out, plain)
    torch.testing.assert_close(out.to(plain.dtype), plain, rtol=2e-2,
                               atol=2e-2)
    assert torch.isneginf(lse[0]).all() and (out[0] == 0).all()
    torch.testing.assert_close(
        lse[1:], lse_of(torch.matmul(qg, k.transpose(-1, -2)).float())[1:],
        rtol=1e-6, atol=1e-6)
    sout, slse = decode_split_ref(q, k, v, vlen, 16, return_lse=True)
    assert torch.isneginf(slse[0]).all()
    torch.testing.assert_close(
        slse[1:], lse_of(torch.matmul(qg.float(), k.float().transpose(
            -1, -2)))[1:], rtol=1e-6, atol=1e-6)
    assert sout.dtype == torch.float32
    assert torch.equal(sout.to(q.dtype), decode_split_ref(q, k, v, vlen, 16))


@pytest.mark.parametrize("blocks", [1, 2, 3, 4])
def test_split_and_combine_equals_whole_cache(blocks):
    """A cache cut into 1-4 blocks of positions, each block's K4 (plain,
    fp32) over its part of every lane's valid length -- empty for many
    (lengths 0, 3 and 37 of 40) -- and the parts merged equal the
    attention over the whole cache within 1e-6."""
    rng = np.random.default_rng(blocks)
    b, h, kv, s, d = 3, 4, 2, 40, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((b, h, d), (b, kv, s, d), (b, kv, s, d)))
    vlen = torch.tensor([0, 3, 37])
    want = decode_attention_ref(q, k, v, vlen)
    cuts = [round(i * s / blocks) for i in range(blocks + 1)]
    outs, lses = [], []
    for lo, hi in zip(cuts, cuts[1:]):
        o, lse = decode_attention_ref(q, k[:, :, lo:hi], v[:, :, lo:hi],
                                      (vlen - lo).clamp(0, hi - lo),
                                      return_lse=True)
        outs.append(o)
        lses.append(lse)
    got = merge_softmax_parts(torch.stack(outs), torch.stack(lses))
    assert not got.isnan().any() and (got[0] == 0).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_cluster_serves_on_the_mesh(world):
    """``launch.serve`` on ``h100x4`` (``Cluster.submit``, the dense
    backend, the ladder's plan: TP, the lanes over 'data'): every rank's
    engine returns the one process's tokens; each data group prefilled
    its 2 of the 4 lanes' prompts; each rank held 2 of the 4 q heads."""
    ranks, one = world["ranks"], world["one"]["serve"]
    want = {r.req_id: r.output_tokens for r in one["requests"]}
    assert len(want) == SERVE["requests"]
    for r in ranks:
        assert r["serve"]["tokens"] == want
        assert r["serve"]["local_prefills"] == 2
        assert r["serve"]["wq"][2] == 2
        assert r["serve"]["plan"]["batch_axes"] == ("data",)


@pytest.mark.parametrize("what", ["paged", "world"])
def test_refused_in_the_world(world, what):
    """Inside the 4-rank world: the paged backend on a mesh and a serve
    plan of an 8-device mesh raise NotImplementedError naming ROADMAP
    item A8d, on every rank."""
    for r in world["ranks"]:
        said = r["refused"][what]
        assert said is not None and "A8d" in said


@pytest.mark.parametrize("what,one", [("fsdp", "serve"),
                                      ("dbrx_fsdp", "dbrx")])
def test_fsdp_plans_serve_in_the_world(world, what, one):
    """Weight-gathered serving, refused until ROADMAP item A8d's part 5:
    ``launch.serve`` on ``h100x4`` with the plan's ``fsdp`` set serves
    reduced command-r-35b (TP; no leaf of it reaches the planner's FSDP
    size) and dbrx-132b (TP + EP, at widths where FSDP splits its
    experts, q heads, embedding and head, so each prefill's data group
    gathers its blocks with the other group joining) through
    ``Cluster.submit``, and every rank's engine returns the one process's
    tokens."""
    want = {r.req_id: r.output_tokens for r in world["one"][one]["requests"]}
    assert len(want) == SERVE["requests"]
    for r in world["ranks"]:
        got = r["fsdp"][what]
        assert got["tokens"] == want
        assert got["plan"]["fsdp"]
        assert got["plan"]["ep"] == (what == "dbrx_fsdp")
        assert (min(got["gathers"]) > 0) == (what == "dbrx_fsdp")


def test_whisper_on_the_mesh_is_refused_as_on_one_card(world):
    """whisper-base submitted to the mesh's dense backend meets the
    encoder-decoder's refusal of one card (a ValueError: its prompts need
    the encoder's frames, which serve through ``Model.prefill``), no
    longer ROADMAP item A8d's, on every rank."""
    for r in world["ranks"]:
        kind, said = r["whisper"]
        assert kind == "ValueError" and "encoder-decoder" in said
        assert "A8d" not in said


class _HostMesh:
    """``h100x4`` seen from its rank 0 with no world: what a serving
    model's layouts read of a ``TorchMesh``."""
    spec = H100X4
    coords = {"data": 0, "model": 0}

    def size(self, axes):
        return int(np.prod([self.spec.axis_size(a) for a in axes]))

    def index(self, axes, coords=None):
        return 0


def test_refused_outside_the_world():
    """With no world a serve plan of ``h100x4`` is refused, naming
    multi-card binding and A8d; whisper under a serving layout meets the
    encoder-decoder's refusal before any weight is made; a decoder block
    over a sequence-sharded cache (``shard_ctx``) raises naming A8d;
    every block kind, whisper's decoder blocks now too, serves on a mesh,
    and dbrx-132b's FSDP plan builds its stored and compute layouts."""
    c = Cluster(pods=1, mesh=H100X4, executor=TorchExecutor(device="cpu"))
    with pytest.raises(NotImplementedError, match="multi-card.*A8d"):
        c.submit(Application.serve("command-r-35b", reduced=True,
                                   serve=ServeOptions(backend="dense")))
    cfg = reduced_config(get_config("whisper-base"))
    plan = Plan(cfg.name, "decode", H100X4, batch_axes=("data",))
    with pytest.raises(ValueError, match="encoder-decoder"):
        DenseRunner(cfg, device="cpu", layout=ServeLayout(plan, None))
    dbrx = reduced_config(get_config("dbrx-132b"), d_model=128)
    model = Model(dbrx, layout=ServeLayout(Plan(
        dbrx.name, "decode", H100X4, batch_axes=("data",), tp=False,
        ep=True, fsdp=True), _HostMesh()))
    # the experts (16, 128, 32) split over ('model', 'data'): a block's
    # gathered leaves are one 'model' rank's 8 experts
    assert model.gather_bytes() == (3 * 8 * 128 * 32 * 2, 0)
    x = torch.zeros(1, 1, cfg.d_model)
    with pytest.raises(NotImplementedError, match="A8d"):
        apply_block_decode(cfg, DEC_ATTN, {}, x, {}, 0, {},
                           shard_ctx=("mesh", ("model",), ("data",)))
    assert set(SERVE_MESH_KINDS) == {ATTN_GLOBAL, ATTN_LOCAL, MOE, MAMBA2,
                                     ATTN_SHARED, RWKV6, DEC_ATTN}


def test_long_context_fsdp_plan_is_refused():
    """dbrx-132b's ``long_500k`` plan on ``h100x4`` (the ladder's: FSDP
    and the cache's sequence both over 'data', batch 1) is refused before
    any weight is made, naming ROADMAP item A8d: weight-gathered serving
    holds its lanes' whole cache on a data group."""
    cfg = get_config("dbrx-132b")
    plan = materialize(cfg, SHAPES["long_500k"], H100X4)
    assert plan.fsdp and plan.seq_axes == ("data",)
    with pytest.raises(NotImplementedError, match="sequence.*A8d"):
        Model(cfg, layout=ServeLayout(plan, _HostMesh()))


def test_serving_plans_lay_out_the_cache():
    """The layouts the serving entry points read: the sequence-sharded
    plan stores the cache ``P(None, 'data', None, 'model', None)`` (the
    reference test's), the ladder's TP plan splits the KV heads over
    'model' and keeps S whole, and ``impl_from_plan`` gives the
    reference's ``decode_shard_ctx`` to the first only."""
    cfg = reduced_config(get_config(SEQ["arch"]))
    specs = T.cache_specs(cfg, SEQ["batch"], SEQ["cache_len"])
    plan = Plan(cfg.name, "decode", H100X4, **SEQ_PLAN)
    assert cache_specs_tree(plan, cfg, specs)["p0_attn_global"]["k"] == \
        P(None, "data", None, "model", None)
    assert impl_from_plan(plan, "mesh").decode_shard_ctx == (
        "mesh", ("model",), ("data",))
    tp_plan = materialize(reduced_config(get_config("command-r-35b")),
                          TP_SHAPE, H100X4)
    tcfg = reduced_config(get_config("command-r-35b"))
    assert cache_specs_tree(tp_plan, tcfg, T.cache_specs(
        tcfg, 4, 64))["p0_attn_global"]["k"] == P(None, "data", "model",
                                                  None, None)
    assert impl_from_plan(tp_plan, "mesh").decode_shard_ctx is None
    assert impl_from_plan(plan).decode_shard_ctx is None


class _Coords:
    """A (2, 2) mesh over ('data', 'model') seen from the rank at
    ``coords`` (what a ``Layout`` reads of a ``TorchMesh``)."""

    def __init__(self, coords):
        self.coords = dict(zip(("data", "model"), coords))

    def size(self, axes):
        return 2 ** len(axes)

    def index(self, axes):
        i = 0
        for a in axes:
            i = 2 * i + self.coords[a]
        return i


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_rank_blocks_of_init_are_one_process_values(monkeypatch, coords):
    """``init_from_specs(..., layouts=...)`` keeps this rank's block of
    each leaf, bit-equal to the block of one process's draw: a leaf drawn
    in runs of 2 rows whose block ends inside a run, a leaf whose row is
    itself drawn in runs, a leaf drawn in one piece."""
    from repro_torch.models import layers as L
    from repro_torch.sharding.planner import Layout
    monkeypatch.setattr(L, "INIT_SLICE_ELEMS", 350)
    specs = {"a": L.Spec((6, 10, 16)), "b": L.Spec((2, 30, 16)),
             "c": L.Spec((6, 10), std=0.5)}
    mesh = _Coords(coords)
    lays = {"a": Layout(mesh, (("data",), (), ("model",))),
            "b": Layout(mesh, ((), ("model",), ())),
            "c": Layout(mesh, ((), ("data", "model")))}
    whole = L.init_from_specs(specs, torch.Generator().manual_seed(5),
                              torch.device("cpu"))
    got = L.init_from_specs(specs, torch.Generator().manual_seed(5),
                            torch.device("cpu"), layouts=lays)
    for k, lay in lays.items():
        assert got[k].shape == lay.local_shape(specs[k].shape)
        assert torch.equal(got[k], lay.local(whole[k]))


class _CoordsX4(_Coords):
    """``_Coords`` that ``planner.to_layout`` accepts: the mesh's spec."""
    spec = H100X4


@pytest.mark.parametrize("coords", [(0, 0), (1, 1)])
def test_bridge_takes_a_ranks_stored_slices(coords):
    """``params_from_jax(..., layouts=...)`` puts the reference's weights
    on this rank's stored slices of a weight-gathered serving plan
    (reduced dbrx-132b at d 128 under TP + EP + FSDP, its experts split
    over ('model', 'data'): 4 of 16 a rank), each leaf the block of the
    whole bridged leaf, bit for bit."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.configs.reduced import reduced_config as jax_reduced
    from repro.models import build_model
    from repro_torch.bridge import params_from_jax
    from repro_torch.models.model import param_specs
    jcfg = jax_reduced(jax_get_config("dbrx-132b"), d_model=128)
    cfg = reduced_config(get_config("dbrx-132b"), d_model=128)
    tree = jax.tree.map(np.asarray, build_model(jcfg).init_params(
        jax.random.PRNGKey(0)))
    plan = Plan(cfg.name, "decode", H100X4, batch_axes=("data",), tp=True,
                ep=True, fsdp=True)
    lays = ServeLayout(plan, _CoordsX4(coords)).params(cfg, param_specs(cfg))
    whole = params_from_jax(tree, cfg, "cpu")
    got = params_from_jax(tree, cfg, "cpu", layouts=lays)
    for (path, a), b, lay in zip(_flatten_with_paths(got),
                                 topt.leaves(whole), topt.leaves(lays)):
        assert torch.equal(a, lay.local(b)), path
    assert got["blocks"]["p0_moe"]["moe"]["we_gate"].shape == (1, 4, 128, 32)
