"""The port's sharded serving of the MoE, recurrent, vision-language and
encoder-decoder families, and weight-gathered (FSDP) serving, against
the JAX package's, on the CPU.

The prefill and decode cells that ``launch/dryrun.py``'s ``lower_cell``
lowers under the ladder's ``decode_32k`` plan on ``h100x4`` (its batch
of 128 cut to 4 lanes, its 32768 positions to 64), for reduced
qwen2-moe-a2.7b (TP over the attention heads and the shared expert's
ffn, EP over the routed experts, under the plan's ``psum`` dispatch and
under ``a2a``), zamba2-2.7b (Mamba-2 and its shared attention block),
rwkv6-7b, phi-3-vision-4.2b with image features ahead of the prompt,
whisper-base with its encoder's frames (TP over the encoder's and the
decoder's self and cross heads and ffn columns, the cross K/V cache split
by its KV heads), and dbrx-132b under the placement of its full-size
ladder plan, TP + EP + FSDP: the weights stored split over 'data' as
well (at ``WIDTHS``, where the planner's FSDP splits the experts, the
attention's q heads and the embedding and head), each block gathered
for its forward.
The reference runs jitted over a (2, 2) mesh of 4 forced host devices in
a subprocess, with its planner's shardings and ``_model_impl``'s
contexts; the port runs on one gloo world of 4 CPU processes laid out as
``h100x4``, (2, 2) over ('data', 'model') (``tests/torch_ranks.py``),
each rank with its lanes and its blocks of the weights, the dense cache
and the recurrent state (the SSM and WKV states split by heads, the
conv and token-shift states whole).  rwkv6 runs the reference at
``scan_chunk=16`` (its RWKV-6 chunk clamp bites at the plan's 128;
``ROADMAP.md``, queue C).

Both sides decode the same fed tokens (numpy, seeded), so every step's
logits compare.  Tolerances: 5e-2 (bf16, logits and cache) against the
reference, each step's greedy token equal to the reference's but where
its top-2 gap is below ``TIE_GAP``; 1e-5 in fp32 against the port's
one-process steps.  The MoE's capacity is per data shard (per slice of
one under ``a2a``), as in the reference's ``shard_map``, so its drops
differ from one process's: the ranks meet the reference at the config's
capacity factor and one process at ``NO_DROP``, where no expert drops a
token.
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
from repro_torch.core.materializer import H100X4, materialize
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.models.transformer import ImplConfig
from repro_torch.serving.serve_step import impl_from_plan
from repro_torch.sharding.planner import cache_specs_tree
from test_torch_sharded_serving import (REF_TOL, ONE_TOL, PLAN_FIELDS,
                                        _all_equal, _as, _caches_close,
                                        _close, _greedy_agrees, _one_decode,
                                        _ref_stack, _weights)
from torch_ranks import run_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2-moe-a2.7b", "zamba2-2.7b", "rwkv6-7b", "phi-3-vision-4.2b",
         "whisper-base", "dbrx-132b")
# (case, arch, the plan's fields replaced; "ladder": the fields of the
# full-size config's decode_32k plan)
CASES = (("qwen2-moe/psum", "qwen2-moe-a2.7b", {}),
         ("qwen2-moe/a2a", "qwen2-moe-a2.7b", {"moe_dispatch": "a2a"}),
         ("zamba2", "zamba2-2.7b", {}),
         ("rwkv6", "rwkv6-7b", {"scan_chunk": 16}),
         ("phi-3-vision", "phi-3-vision-4.2b", {}),
         ("whisper", "whisper-base", {}),
         ("dbrx/fsdp", "dbrx-132b", "ladder"))
# the reduced configs' widths beside ``reduced_config``'s: dbrx's at which
# leaves reach the planner's FSDP_MIN_ELEMS (the experts (16, 256, 32),
# wq (256, 8, 32), the embedding and head (512, 256)), its GQA kept (8
# q heads over 4 KV heads)
WIDTHS = {"dbrx-132b": dict(d_model=256, num_heads=8, num_kv_heads=4,
                            head_dim=32, vocab_size=512)}
SHAPE = dataclasses.replace(SHAPES["decode_32k"], global_batch=4,
                            seq_len=64)
# a 48-token prompt (even: a2a splits each data shard's tokens over
# 'model'; a multiple of the reference's rwkv6 chunk of 16), phi-3's
# 8 image tokens ahead of it (whisper's encoder over its 16 frames), 8
# fed steps
PROMPT, STEPS = 48, 8
# a capacity factor at which no expert of the reduced MoE overflows
NO_DROP = 16.0
FIELDS = PLAN_FIELDS + ("ep", "moe_dispatch", "scan_chunk")

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
from repro.models import build_model
from repro.serving.serve_step import make_decode_step, make_prefill_step
from repro.sharding import planner

inp = np.load(sys.argv[1])
cases = json.load(open(sys.argv[2]))
mesh = _make_mesh((2, 2), ("data", "model"))
spec = MeshSpec("h100x4", (2, 2), ("data", "model"))
out = {}


def params_of(arch):
    tree, pre = {}, arch + "/p/"
    for key in inp.files:
        if key.startswith(pre):
            node, *path = tree, *key[len(pre):].split("/")
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = jnp.asarray(inp[key], jnp.bfloat16)
    return tree


for name, c in cases.items():
    arch = c["arch"]
    cfg = reduced_config(get_config(arch), **c["width"])
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
    batch = {"tokens": jnp.asarray(prompt)}
    in_batch = {"tokens": b_sh}
    for key, feats in (("img", "img_feats"), ("enc", "enc_feats")):
        if f"{arch}/{key}" in inp.files:
            batch[feats] = jnp.asarray(inp[f"{arch}/{key}"], jnp.bfloat16)
            in_batch[feats] = NamedSharding(mesh, P("data", None, None))
    with mesh:
        prefill = jax.jit(make_prefill_step(pm, cl),
                          in_shardings=(p_sh, in_batch),
                          out_shardings=(None, c_sh))
        first, cache = prefill(params, batch)
        out[f"{name}/first"] = np.asarray(first, np.float32)
        decode = jax.jit(make_decode_step(dm),
                         in_shardings=(p_sh, b_sh, c_sh,
                                       NamedSharding(mesh, P())),
                         out_shardings=(b_sh, None, c_sh))
        for i in range(feed.shape[1]):
            nxt, lg, cache = decode(params, jnp.asarray(feed[:, i:i + 1]),
                                    cache, jnp.asarray(c["pos"] + i,
                                                       jnp.int32))
            out[f"{name}/logits/{i}"] = np.asarray(lg, np.float32)
            out[f"{name}/next/{i}"] = np.asarray(nxt)
    for key, leaf in cache.items():
        for leaf_name, a in leaf.items():
            out[f"{name}/cache/{key}/{leaf_name}"] = np.asarray(a, np.float32)
np.savez(sys.argv[3], **out)
"""


def _no_drop(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=NO_DROP)) if cfg.moe else cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's runs (a subprocess with 4 forced host devices) and,
    beside them, the port's one-process fp32 steps and one gloo world of
    4 ranks (``torch_ranks.sharded_families``)."""
    d = tmp_path_factory.mktemp("families")
    rng = np.random.default_rng(0)
    inputs, ref_cases, cases, one, data = {}, {}, {}, {}, {}
    for arch in ARCHS:
        cfg = reduced_config(get_config(arch), **WIDTHS.get(arch, {}))
        params = _weights(cfg, rng)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (SHAPE.global_batch, PROMPT)))
        feed = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (SHAPE.global_batch, STEPS)))
        img = None
        if cfg.family == "vlm":
            img = torch.from_numpy(rng.standard_normal(
                (SHAPE.global_batch, cfg.num_image_tokens, 1024)).astype(
                    np.float32)).to(torch.bfloat16)
            inputs[f"{arch}/img"] = img.float().numpy()
        enc = None
        if cfg.is_encdec:
            enc = torch.from_numpy(rng.standard_normal(
                (SHAPE.global_batch, cfg.encoder_seq_len,
                 cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
            inputs[f"{arch}/enc"] = enc.float().numpy()
        for path, t in _flatten_with_paths(params):
            inputs[f"{arch}/p/{path}"] = t.float().numpy()
        inputs[f"{arch}/prompt"] = prompt.int().numpy()
        inputs[f"{arch}/feed"] = feed.int().numpy()
        data[arch] = (cfg, params, prompt, feed, img, enc)
    for name, arch, fields in CASES:
        cfg, params, prompt, feed, img, enc = data[arch]
        if fields == "ladder":
            full = materialize(get_config(arch), SHAPES["decode_32k"],
                               H100X4)
            fields = {k: getattr(full, k) for k in FIELDS}
        plan = dataclasses.replace(materialize(cfg, SHAPE, H100X4), **fields)
        pos = PROMPT + (0 if img is None else img.shape[1])
        ref_cases[name] = {"arch": arch, "cache_len": SHAPE.seq_len,
                           "pos": pos, "width": WIDTHS.get(arch, {}),
                           "plan": {k: getattr(plan, k) for k in FIELDS}}
        for dt, c, dtype in (("bf16", cfg, torch.bfloat16),
                             ("fp32", _no_drop(cfg), torch.float32)):
            cases[f"{name}/{dt}"] = {
                "cfg": c, "plan": plan, "dtype": dtype,
                "params": _as(params, dtype), "prompt": prompt, "feed": feed,
                "img": img, "enc": enc, "pos": pos,
                "cache_len": SHAPE.seq_len}
    np.savez(d / "inputs.npz", **inputs)
    (d / "cases.json").write_text(json.dumps(ref_cases))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               TF_CPP_MIN_LOG_LEVEL="3", JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "inputs.npz"),
         str(d / "cases.json"), str(d / "reference.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for arch, (cfg, params, prompt, feed, img, enc) in data.items():
        cfg = _no_drop(cfg)
        p32 = _as(params, torch.float32)
        m = Model(cfg, ImplConfig(remat="none"))
        cache = m.init_cache(SHAPE.global_batch, SHAPE.seq_len, "cpu",
                             torch.float32)
        first, cache = m.prefill(p32, prompt, SHAPE.seq_len, cache=cache,
                                 img_feats=None if img is None
                                 else img.float(),
                                 enc_feats=None if enc is None
                                 else enc.float())
        pos = PROMPT + (0 if img is None else img.shape[1])
        logits, nxt, cache = _one_decode(cfg, p32, cache, feed, pos)
        one[arch] = {"first": first, "logits": logits, "next": nxt,
                     "cache": cache}
    torch.save(cases, d / "families.pt")
    run_world("sharded_families", 4, d)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-4000:]
    return {"reference": np.load(d / "reference.npz"), "one": one,
            "plans": {name: cases[f"{name}/bf16"]["plan"]
                      for name, _, _ in CASES},
            "ranks": [torch.load(d / f"families_{r}.pt", weights_only=False)
                      for r in range(4)]}


def _case_arch(name):
    return next(arch for case, arch, _ in CASES if case == name)


@pytest.mark.parametrize("name", [c for c, _, _ in CASES])
def test_families_match_the_reference(world, name):
    """Prefill and decode under the ladder's ``decode_32k`` plan on
    ``h100x4`` against the reference's ``make_prefill_step`` /
    ``make_decode_step`` jitted with the planner's shardings as
    ``lower_cell`` builds them (the MoE's ``ep_shard_ctx`` and dispatch
    from ``_model_impl``): the prefill's and every step's logits within
    5e-2, every step's greedy token equal under the ``TIE_GAP`` rule, the
    final cache -- KV, SSM, conv, WKV and token-shift leaves -- within
    5e-2."""
    ref, ranks = world["reference"], world["ranks"]
    key = f"{name}/bf16"
    first = _all_equal(ranks, lambda r: r[key]["first"])
    _close(first.float().numpy(), ref[f"{name}/first"], REF_TOL)
    logits = _all_equal(ranks, lambda r: r[key]["logits"]).float().numpy()
    want = _ref_stack(ref, f"{name}/logits", STEPS)
    _close(logits, want, REF_TOL)
    _greedy_agrees(_all_equal(ranks, lambda r: r[key]["next"]), want)
    _caches_close(ranks[0][key]["cache"], ref, f"{name}/cache", REF_TOL)
    leaves = {n for leaf in ranks[0][key]["cache"].values() for n in leaf}
    arch = _case_arch(name)
    want_leaves = {"qwen2-moe-a2.7b": {"k", "v"},
                   "zamba2-2.7b": {"k", "v", "ssm", "conv"},
                   "rwkv6-7b": {"wkv", "shift_t", "shift_c"},
                   "phi-3-vision-4.2b": {"k", "v"},
                   "whisper-base": {"k", "v", "cross_k", "cross_v"},
                   "dbrx-132b": {"k", "v"}}[arch]
    assert leaves == want_leaves


@pytest.mark.parametrize("name", [c for c, _, _ in CASES])
def test_families_match_one_process(world, name):
    """In fp32 (the MoE at ``NO_DROP``) the ranks' prefill, decode steps
    and cache are the one-process steps' within 1e-5, the greedy tokens
    equal; every rank ran the plan's expert-parallel context and
    dispatch where the plan has ``ep``."""
    ranks = world["ranks"]
    one = world["one"][_case_arch(name)]
    key = f"{name}/fp32"
    _close(_all_equal(ranks, lambda r: r[key]["first"]).numpy(),
           one["first"].numpy(), ONE_TOL)
    _close(_all_equal(ranks, lambda r: r[key]["logits"]).numpy(),
           one["logits"].numpy(), ONE_TOL)
    assert torch.equal(_all_equal(ranks, lambda r: r[key]["next"]),
                       one["next"])
    for leaf_key, leaf in ranks[0][key]["cache"].items():
        for n, t in leaf.items():
            _close(t.numpy(), one["cache"][leaf_key][n].numpy(), ONE_TOL)
    plan = world["plans"][name]
    for rank in ranks:
        assert rank[key]["ep"] == plan.ep
        assert rank[key]["dispatch"] == plan.moe_dispatch


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b",
                                  "whisper-base"])
def test_rank_state_split_by_heads(world, arch):
    """Each rank's cache blocks as the reference's ``cache_specs_tree``
    lays them out: 2 of the 4 lanes, the SSM state (16 heads of 8 x 8) and
    the WKV state (4 heads of 16 x 16) split by heads over 'model', the
    conv state (d_inner 128 + 2 x 8) and the token-shift carries whole,
    the shared block's KV heads split; whisper's self and cross K/V split
    by their KV heads (2 of 4), the cross K/V over all 16 frames."""
    name = {"zamba2-2.7b": "zamba2", "rwkv6-7b": "rwkv6",
            "whisper-base": "whisper"}[arch]
    want = {"zamba2-2.7b": {
        "p0_mamba2": {"ssm": (1, 2, 8, 8, 8), "conv": (1, 2, 3, 144)},
        "p5_attn_shared": {"k": (1, 2, 2, 64, 16), "v": (1, 2, 2, 64, 16)}},
        "rwkv6-7b": {"p0_rwkv6": {"wkv": (1, 2, 2, 16, 16),
                                  "shift_t": (1, 2, 1, 64),
                                  "shift_c": (1, 2, 1, 64)}},
        "whisper-base": {"p0_dec_attn": {
            "k": (1, 2, 2, 64, 16), "v": (1, 2, 2, 64, 16),
            "cross_k": (1, 2, 2, 16, 16), "cross_v": (1, 2, 2, 16, 16)}}}[arch]
    for rank in world["ranks"]:
        for dt in ("bf16", "fp32"):
            shapes = rank[f"{name}/{dt}"]["cache_shapes"]
            for key, leaves in want.items():
                assert shapes[key] == leaves


@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_are_the_reference(arch):
    """``ServeLayout.cache``'s specs (the port's ``cache_specs_tree``)
    equal the reference's for every leaf of the full config's cache at
    the ladder's ``decode_32k`` plan on ``h100x4`` -- the SSM and WKV
    states by heads over 'model', the conv and token-shift states over
    the batch only, the KV heads over 'model' (host arithmetic)."""
    from repro.configs import get_config as jax_get_config
    from repro.models import ImplConfig as JaxImpl
    from repro.models import build_model
    from repro.sharding import planner as jax_planner
    cfg, shape = get_config(arch), SHAPES["decode_32k"]
    plan = materialize(cfg, shape, H100X4)
    jcfg = jax_get_config(arch)
    jplan = _jax_plan(plan)
    got = cache_specs_tree(plan, cfg, T.cache_specs(
        cfg, shape.global_batch, shape.seq_len))
    want = jax_planner.cache_specs_tree(jplan, jcfg, build_model(
        jcfg, JaxImpl(remat="none")).cache_specs(shape.global_batch,
                                                  shape.seq_len))
    assert sorted(got) == sorted(want)
    seen = set()
    for key, leaf in got.items():
        assert sorted(leaf) == sorted(want[key])
        for n, spec in leaf.items():
            assert tuple(spec) == tuple(want[key][n]), (key, n)
            seen.add(n)
    assert seen == {"qwen2-moe-a2.7b": {"k", "v"},
                    "zamba2-2.7b": {"k", "v", "ssm", "conv"},
                    "rwkv6-7b": {"wkv", "shift_t", "shift_c"},
                    "phi-3-vision-4.2b": {"k", "v"},
                    "whisper-base": {"k", "v", "cross_k", "cross_v"},
                    "dbrx-132b": {"k", "v"}}[arch]


def _jax_plan(plan):
    """The reference's ``Plan`` with the port's plan's placing fields, on
    the reference's description of the (2, 2) mesh (its materializer
    knows TPU meshes only), as the reference subprocess builds it."""
    from repro.core.materializer import MeshSpec, Plan
    return Plan(plan.arch, plan.shape,
                MeshSpec("h100x4", (2, 2), ("data", "model")),
                **{k: getattr(plan, k) for k in FIELDS})


@pytest.mark.parametrize("dispatch,decode", [("psum", False),
                                             ("a2a", True)])
def test_impl_from_plan_is_the_reference_model_impl(dispatch, decode):
    """``impl_from_plan`` sets the expert-parallel context and the
    dispatch of a plan with ``ep`` as the reference's
    ``dryrun._model_impl`` does (mesh, 'model', the batch axes), and no
    ``decode_shard_ctx`` where the plan keeps the sequence whole; a plan
    without ``ep`` (zamba2's) gets no expert context."""
    from repro.launch.dryrun import _model_impl
    for arch in ("qwen2-moe-a2.7b", "zamba2-2.7b"):
        plan = dataclasses.replace(materialize(
            get_config(arch), SHAPES["decode_32k"], H100X4),
            moe_dispatch=dispatch)
        jplan = _jax_plan(plan)
        got = impl_from_plan(plan, "mesh")
        want = _model_impl(jplan, False, None, "mesh", is_decode=decode)
        assert plan.ep == (arch == "qwen2-moe-a2.7b")
        assert got.ep_shard_ctx == want.ep_shard_ctx
        assert got.moe_dispatch == want.moe_dispatch == dispatch
        assert got.decode_shard_ctx == want.decode_shard_ctx is None
        if plan.ep:
            assert got.ep_shard_ctx == ("mesh", "model", ("data",))


@pytest.mark.parametrize("dt", ["bf16", "fp32"])
def test_fsdp_serving_gathers_one_block_at_a_time(world, dt):
    """Under dbrx-132b's TP + EP + FSDP plan each rank stores a quarter of
    every leaf FSDP splits -- 4 of the 16 routed experts, 2 of wq's 8
    heads, 128 of the embedding's and the head's 512 vocab rows -- and
    the most gathered bytes alive at once over the prefill and the decode
    steps are exactly one block's gathered leaves plus the components
    outside the blocks on their compute layout (``Model.gather_bytes``):
    each block is gathered for its forward and freed before the next."""
    for rank in world["ranks"]:
        got = rank[f"dbrx/fsdp/{dt}"]
        stored = got["stored"]
        for leaf in ("we_gate", "we_up"):
            assert stored[f"blocks/p0_moe/moe/{leaf}"] == (1, 4, 256, 32)
        assert stored["blocks/p0_moe/moe/we_down"] == (1, 4, 32, 256)
        assert stored["blocks/p0_moe/attn/wq"] == (1, 256, 2, 32)
        assert stored["embed/tok"] == (128, 256)
        assert stored["embed/head"] == (256, 128)
        block, shared = got["gather_bytes"]
        itemsize = 2 if dt == "bf16" else 4
        # the compute layout: 8 experts of 256 x 32 (three leaves), 4 q
        # heads of wq and wo, 256 vocab rows of the embedding and head
        assert block == (3 * 8 * 256 * 32 + 2 * 256 * 4 * 32) * itemsize
        assert shared == 2 * 256 * 256 * itemsize
        assert got["gathered_peak"] == block + shared


def test_impl_from_plan_of_an_fsdp_plan_is_the_reference_model_impl():
    """dbrx-132b's ``decode_32k`` plan on ``h100x4`` (TP + EP + FSDP):
    ``impl_from_plan`` sets what the reference's ``dryrun._model_impl``
    sets -- the expert-parallel context and the plan's dispatch, no
    ``decode_shard_ctx`` -- and nothing for FSDP, which the port's
    ``Model`` reads from its layout."""
    from repro.launch.dryrun import _model_impl
    plan = materialize(get_config("dbrx-132b"), SHAPES["decode_32k"], H100X4)
    assert plan.fsdp and plan.ep and plan.tp
    got = impl_from_plan(plan, "mesh")
    for decode in (False, True):
        want = _model_impl(_jax_plan(plan), False, None, "mesh",
                           is_decode=decode)
        assert got.ep_shard_ctx == want.ep_shard_ctx == (
            "mesh", "model", ("data",))
        assert got.moe_dispatch == want.moe_dispatch
        assert got.decode_shard_ctx == want.decode_shard_ctx is None
        assert got.remat == want.remat == "none"


class _SeqMesh:
    """A mesh seen from one rank that splits the sequence over 'model'
    in 2 blocks (what the decode reads of a ``TorchMesh`` before it
    refuses)."""

    def size(self, axes):
        return 2

    def index(self, axes):
        return 0


@pytest.mark.parametrize("what", ["multi_pod", "tp_over_seq"])
def test_remaining_refusals_name_a8d(what):
    """What this slice leaves refused still names ROADMAP item A8d: a
    Cluster of several pods with the ``TorchExecutor`` (one pod until the
    multi-card slice), and a decode whose q heads are split over 'model'
    while its cache splits the sequence over 'model' too (each rank would
    need the other ranks' keys of its heads)."""
    from repro_torch.models import attention as attn
    from repro_torch.runtime import Cluster, TorchExecutor
    from repro_torch.sharding.collectives import TensorParallel
    if what == "multi_pod":
        with pytest.raises(NotImplementedError, match="A8d"):
            Cluster(pods=2, executor=TorchExecutor(device="cpu"))
        return
    cfg = reduced_config(get_config("command-r-35b"))
    h, kv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    p = {"wq": torch.zeros(d, h // 2, hd), "wk": torch.zeros(d, kv // 2, hd),
         "wv": torch.zeros(d, kv // 2, hd), "wo": torch.zeros(h // 2, hd, d)}
    cache = {"k": torch.zeros(1, kv // 2, 8, hd),
             "v": torch.zeros(1, kv // 2, 8, hd)}
    with pytest.raises(NotImplementedError, match="A8d"):
        attn.self_attention_decode(
            p, torch.zeros(1, 1, d), cache, 3, cfg,
            tp=TensorParallel(None, 2, 0),
            shard_ctx=(_SeqMesh(), ("model",), ("data",)))
