"""The port's expert parallelism against the JAX package's, on the CPU.

The counterpart of ``tests/test_distributed.py``'s
``test_moe_shard_map_equals_local``: the reference runs ``moe_block``
under ``shard_map`` over a (2, 2) mesh of 4 forced host devices (in a
subprocess, so this process keeps its one device); the port runs it on
a gloo world of 4 CPU processes (``tests/torch_ranks.py``) laid out as
``h100x4``, each rank with its data shard's rows and its block of the
experts.  The same world trains a mid-width qwen2-moe-a2.7b through
``launch.train`` under TP + EP (both dispatches) + ZeRO + FSDP against
one process, and restores the EP-sharded params onto a (4, 1) mesh.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import _flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig, ShapeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.compile_cache import plan_layout_key
from repro_torch.core.materializer import H100X4, Plan
from repro_torch.launch.train import train
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.models.transformer import ImplConfig
from repro_torch.sharding.collectives import TensorParallel
from repro_torch.training import optimizer as topt
from torch_ranks import captured_grads, routing_order, run_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISPATCHES = ("psum", "a2a")
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# y and aux of the sharded block: the reference test's limits in bf16
# (6e-2, 4e-2), in fp32 1e-5
BLOCK_TOL = {"bf16": (6e-2, 4e-2), "fp32": (1e-5, 1e-5)}

# the reference's block on the (2, 2) mesh, both dispatches and dtypes:
# reduced qwen2-moe-a2.7b (8 experts padded to 16, top 2, two shared),
# PRNGKey(0) weights and a (4, 8) batch from PRNGKey(1), as its own test
REFERENCE = """
import sys; sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.reduced import reduced_config
from repro.launch.mesh import _make_mesh
from repro.models import layers as L
from repro.models.moe import moe_block
from repro.models.transformer import block_specs
cfg = reduced_config(get_config("qwen2-moe-a2.7b"))
mesh = _make_mesh((2, 2), ("data", "model"))
p = L.init_from_specs(jax.random.PRNGKey(0), block_specs(cfg, "moe")["moe"])
x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, cfg.d_model),
                      jnp.bfloat16)
out = {{}}
flat, tree = jax.tree_util.tree_flatten_with_path(p)
for path, leaf in flat:
    out["p/" + "/".join(k.key for k in path)] = np.asarray(leaf, np.float32)
out["x"] = np.asarray(x, np.float32)
for dt, dtype in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
    pd = jax.tree.map(lambda a: a.astype(dtype), p)
    xd = x.astype(dtype)
    for dispatch in ("psum", "a2a"):
        with mesh:
            y, aux = jax.jit(lambda p, x: moe_block(
                p, x, cfg, shard_ctx=(mesh, "model", ("data",)),
                dispatch=dispatch))(pd, xd)
        out[f"y/{{dt}}/{{dispatch}}"] = np.asarray(y, np.float32)
        out[f"aux/{{dt}}/{{dispatch}}"] = np.asarray(aux, np.float32)
np.savez({path!r}, **out)
"""


def _mid_qwen2_moe(capacity_factor):
    """qwen2-moe-a2.7b's pattern (MoE blocks, shared experts) at widths
    whose leaves pass the planner's FSDP_MIN_ELEMS, so ZeRO and FSDP split
    them: 8 experts padded to 16 (8 a rank over 'model'), top 2."""
    return get_config("qwen2-moe-a2.7b").scaled(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, moe=MoEConfig(
            num_experts=8, top_k=2, d_expert=64, num_shared_experts=1,
            d_shared_expert=256, capacity_factor=capacity_factor))


# the capacity factor at which no pair drops: cap = tokens * top_k * cf /
# e_pad >= tokens, so every dispatch computes the one-process function
NO_DROP = 16 / 2
TRAIN_SHAPE = ShapeConfig("mid_b8", "train", 32, 8)
TRAIN_PLAN = {"tp": True, "ep": True, "zero": True, "fsdp": True,
              "batch_axes": ("data",), "remat": "full", "microbatch": 2}
TRAIN_STEPS = 3


# the mesh's shards of one routing's tokens (contiguous, equal): psum
# routes each data shard's tokens, a2a each (data, model) slice of them
AUX_PARTS = {"psum": 2, "a2a": 4}


@contextlib.contextmanager
def mesh_routing(record: list, calls: int, parts: int):
    """One process computing the mesh's function: each MoE routing's
    balance loss is the mean of its ``parts`` token shards' (the
    reference's ``pmean`` of the shards' losses, where a single shard's
    is over all its tokens), and the expert ids of the first ``calls``
    routings are appended to ``record``."""
    plain = moe.route

    def route(p, x, cfg):
        weights, ids, _ = plain(p, x, cfg)
        if len(record) < calls:
            record.append(ids.detach().clone())
        probs = moe.router_probs(p, x, cfg)
        auxes = [moe.routed(pr, i, cfg, x.dtype)[1]
                 for pr, i in zip(probs.chunk(parts), ids.chunk(parts))]
        return weights, ids, sum(auxes) / parts

    moe.route = route
    try:
        yield
    finally:
        moe.route = plain


def _route_table(record, cfg, shape, plan):
    """Per layer, the (B, S, k) expert ids of the global batch's tokens
    from one process's step-1 routings in call order (microbatch i routes
    rows i::mb; the forward's routings come first)."""
    mb = plan["microbatch"]
    per = len(routing_order(cfg.num_layers, plan["remat"]))
    table = torch.zeros(cfg.num_layers, shape.global_batch, shape.seq_len,
                        cfg.moe.top_k, dtype=torch.long)
    for i in range(mb):
        for layer in range(cfg.num_layers):
            ids = record[i * per + layer]
            table[layer, i::mb] = ids.view(-1, shape.seq_len, cfg.moe.top_k)
    return table


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's sharded blocks (a subprocess with 4 forced host
    devices); meanwhile, the one-process training runs, one a dispatch
    (:func:`mesh_routing`), their step-1 routings recorded; then one gloo
    world of 4 ranks running the port's blocks on the reference's weights
    and inputs, ``launch.train`` of both dispatches (step 1 routed as the
    one process routed it) and the restore
    (``torch_ranks.expert_parallel``)."""
    d = tmp_path_factory.mktemp("ep")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               TF_CPP_MIN_LOG_LEVEL="3", JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE).format(
            src=os.path.join(ROOT, "src"), path=str(d / "reference.npz"))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    ocfg = topt.OptimizerConfig(warmup_steps=1)
    cfg_train = _mid_qwen2_moe(NO_DROP)
    one, cases = {}, {}
    calls = TRAIN_PLAN["microbatch"] * len(routing_order(
        cfg_train.num_layers, TRAIN_PLAN["remat"]))
    for dispatch in DISPATCHES:
        record = []
        with captured_grads([]) as grads, mesh_routing(
                record, calls, AUX_PARTS[dispatch]):
            one[dispatch] = train(
                cfg_train, shape=TRAIN_SHAPE,
                overrides={k: TRAIN_PLAN[k] for k in ("remat", "microbatch")},
                opt_cfg=ocfg, device="cpu", steps=TRAIN_STEPS, seed=0,
                verbose=False)
        one[dispatch]["grads"] = grads[0]
        cases[dispatch] = {
            "cfg": cfg_train, "shape": TRAIN_SHAPE,
            "overrides": dict(TRAIN_PLAN, moe_dispatch=dispatch),
            "opt": ocfg, "steps": TRAIN_STEPS, "restore": dispatch == "a2a",
            "routes": _route_table(record, cfg_train, TRAIN_SHAPE,
                                   TRAIN_PLAN)}
    torch.save(cases, d / "ep_train.pt")

    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-4000:]
    cfg = reduced_config(get_config("qwen2-moe-a2.7b"))
    got = np.load(d / "reference.npz")
    params = {}
    for key in got.files:
        if key.startswith("p/"):
            node, *path = params, *key[2:].split("/")
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.from_numpy(got[key])
    assert sorted(params) == sorted(moe.moe_specs(cfg))
    x = torch.from_numpy(got["x"])
    nodrop = cfg.scaled(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=NO_DROP))
    blocks = {"cfg": cfg, "cases": {}}
    for dt, dtype in DTYPES.items():
        for dispatch in DISPATCHES:
            case = {"params": topt.tree_map(lambda t: t.to(dtype), params),
                    "x": x.to(dtype), "dispatch": dispatch}
            blocks["cases"][f"{dt}/{dispatch}"] = case
            blocks["cases"][f"{dt}/{dispatch}/nodrop"] = dict(case,
                                                              cfg=nodrop)
    torch.save(blocks, d / "blocks.pt")
    run_world("expert_parallel", 4, d)
    return {"dir": d, "reference": got, "blocks": blocks,
            "ranks": [torch.load(d / f"blocks_{r}.pt", weights_only=False)
                      for r in range(4)],
            "train": torch.load(d / "ep_train_out.pt", weights_only=False),
            "one": one}


def _ranks_y(world, name):
    """The ranks' y rows in the batch's order: data rank d's rows are
    block d; both model ranks of a data row hold the same rows."""
    ranks = world["ranks"]
    for r in (1, 3):
        assert torch.equal(ranks[r][name]["y"], ranks[r - 1][name]["y"])
    return torch.cat([ranks[0][name]["y"], ranks[2][name]["y"]])


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_sharded_block_matches_the_reference(world, dt, dispatch):
    """The port's ``moe_block`` over the (2, 2) mesh against the
    reference's under the same ``shard_ctx`` and dispatch: y within
    ``BLOCK_TOL`` elementwise (rtol = atol), the aux (the mean over every
    rank, the same on all four) too.  Each rank held 8 of the 16 padded
    experts."""
    name = f"{dt}/{dispatch}"
    y_tol, aux_tol = BLOCK_TOL[dt]
    y = _ranks_y(world, name)
    assert y.dtype == DTYPES[dt]
    want = world["reference"][f"y/{dt}/{dispatch}"]
    np.testing.assert_allclose(y.float().numpy(), want, rtol=y_tol,
                               atol=y_tol)
    auxes = {r[name]["aux"] for r in world["ranks"]}
    assert len(auxes) == 1
    assert abs(auxes.pop() - float(world["reference"][f"aux/{dt}/{dispatch}"])
               ) <= aux_tol
    assert all(r[name]["experts"][0] == 8 for r in world["ranks"])


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_sharded_block_matches_the_local_block(world, dt, dispatch):
    """The port's sharded block against its own single-shard block on the
    whole batch.  At the config's capacity factor the local block's
    capacity is over all 32 tokens and drops pairs that the shards'
    (over 16 or 8 tokens) keep, and the aux is the mean of the shards'
    balance losses where the local block's is the whole batch's: both
    within the reference test's limits (y 6e-2, aux 4e-2).  At a
    capacity factor at which no pair drops (``NO_DROP``) the functions
    are the same, and in fp32 y agrees within 1e-5."""
    cfg = world["blocks"]["cfg"]
    for name, tol, drops in ((f"{dt}/{dispatch}", 6e-2, 9),
                             (f"{dt}/{dispatch}/nodrop",
                              BLOCK_TOL[dt][0], 0)):
        case = world["blocks"]["cases"][name]
        with _drops() as dropped:
            y0, aux0 = moe.moe_block(case["params"], case["x"],
                                     case.get("cfg", cfg))
        assert dropped == [drops]
        y = _ranks_y(world, name)
        np.testing.assert_allclose(y.float().numpy(), y0.float().numpy(),
                                   rtol=tol, atol=tol)
        assert abs(world["ranks"][0][name]["aux"] - float(aux0)) <= 4e-2


class _drops:
    """The (token, k) pairs each routing drops while the block runs."""

    def __enter__(self):
        self.plain, self.log = moe.dispatch_slots, []

        def counting(ids, e_total, cap):
            slot, keep = self.plain(ids, e_total, cap)
            self.log.append(int((~keep).sum()))
            return slot, keep

        moe.dispatch_slots = counting
        return self.log

    def __exit__(self, *exc):
        moe.dispatch_slots = self.plain


def test_the_exchange_took_gloos_own_route(world):
    """Every all-to-all of the a2a blocks went through gloo as is (CPU
    tensors): 2 exchanges a block, 4 blocks."""
    for r in world["ranks"]:
        assert r["routes"] == {"nccl": 0, "gloo": 8}


def _leaf_names(world):
    return [key for key, _ in
            _flatten_with_paths(world["one"]["psum"]["params"])]


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_ep_train_step_matches_one_process(world, dispatch):
    """``launch.train`` on ``h100x4`` with TP + EP (``dispatch``) + ZeRO +
    FSDP over 'data' at the no-drop capacity factor, against one process
    on the same seeded weights and batches computing the mesh's function
    (:func:`mesh_routing`: the balance loss is the mean of the shards',
    which no capacity factor makes the whole microbatch's), step 1
    routed alike: losses within 1e-3 relative, every leaf's step-1
    gradient (averaged over the batch, gathered whole) within 2e-2
    relative norm -- the router's and the shared experts' named -- and
    the params after 3 steps within 1e-2 relative norm.  Each rank held
    8 of the 16 padded experts, split again over 'data' for storage."""
    one, four = world["one"][dispatch], world["train"][dispatch]
    plan = four["plan"]
    assert (plan["batch_axes"], plan["tp"], plan["ep"], plan["zero"],
            plan["fsdp"], plan["moe_dispatch"]) == (
        ("data",), True, True, True, True, dispatch)
    names = _leaf_names(world)
    gate = names.index("blocks/p0_moe/moe/we_gate")
    assert four["local_shapes"][gate] == (2, 4, 128, 64)
    losses = [m["loss"] for m in four["metrics"]]
    want = [m["loss"] for m in one["metrics"]]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want, rtol=1e-3)
    errs = {n: float((a - b).norm() / b.norm())
            for n, a, b in zip(names, four["grads"], one["grads"])}
    for leaf in ("router", "shared/wi_gate", "shared/wi_up", "shared/wo",
                 "shared_gate", "we_gate", "we_up", "we_down"):
        assert f"blocks/p0_moe/moe/{leaf}" in errs
    bad = {n: e for n, e in errs.items() if not e <= 2e-2}
    assert not bad, bad
    num = sum(float((a.float() - b.float()).square().sum()) for a, b in
              zip(topt.leaves(four["params"]), topt.leaves(one["params"])))
    den = sum(float(b.float().square().sum())
              for b in topt.leaves(one["params"]))
    assert (num / den) ** 0.5 <= 1e-2


def test_ep_params_restore_onto_another_mesh(world):
    """The a2a run's EP-sharded params, saved from the ranks' blocks,
    restored onto a (4, 1) mesh (the experts split 4 ways over 'data'
    by FSDP, the 'model' axis one rank) bit-equal on every rank, and
    whole in one process bit-equal."""
    d = world["dir"]
    ranks = [torch.load(d / f"ep_restore_{r}.pt", weights_only=False)
             for r in range(4)]
    assert all(all(r["equal"]) for r in ranks)
    assert ranks[0]["one"] is True
    gate = _leaf_names(world).index("blocks/p0_moe/moe/we_gate")
    assert ranks[0]["specs"][gate] == (None, ("model", "data"), None, None)


def test_dispatches_compile_apart():
    """The compile cache's key tells the two dispatches apart."""
    plans = [Plan("qwen2-moe-a2.7b", "train_4k", H100X4, tp=True, ep=True,
                  moe_dispatch=dispatch) for dispatch in DISPATCHES]
    keys = {plan_layout_key("qwen2-moe-a2.7b", "train_4k", "h100x4", p)
            for p in plans}
    assert len(keys) == 2


def test_tp_moe_needs_expert_parallelism():
    """Under tensor parallelism an MoE stack's routed experts run
    expert-parallel: without ``ep_shard_ctx`` the model is refused (the
    experts' ffn columns split over 'model' are not ported), with it the
    MoE pattern is admitted; a shard_ctx whose batch axes hold 'model'
    is refused by the block."""
    cfg = reduced_config(get_config("qwen2-moe-a2.7b"))
    tp = TensorParallel(None, 2, 0)
    with pytest.raises(NotImplementedError, match="expert-parallel"):
        Model(cfg, ImplConfig(), tp=tp)
    Model(cfg, ImplConfig(ep_shard_ctx=("mesh", "model", ("data",))), tp=tp)
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(ValueError, match="must not"):
        moe.moe_block({}, x, cfg, shard_ctx=("mesh", "model",
                                             ("data", "model")))
