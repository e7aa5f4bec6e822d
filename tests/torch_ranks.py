"""Rank programs of ``tests/test_torch_distributed.py``,
``tests/test_torch_expert_parallel.py``,
``tests/test_torch_deep_sharded.py``,
``tests/test_torch_sharded_serving.py`` and
``tests/test_torch_sharded_families.py``.

Each rank of a world runs in its own process (:func:`run_world` starts
them)::

    python tests/torch_ranks.py <program> <rank> <world> <dir>

joins a gloo world through a ``file://`` store in ``<dir>`` (no TCP
port, so concurrent test workers cannot collide), runs ``<program>`` on
the CPU and leaves its results in ``<dir>`` for the test to read.  The
module imports the port only (never JAX): the test holds the results
against the JAX package in its own process.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import traceback

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.checkpoint.checkpointer import (  # noqa: E402
    _flatten_with_paths)
from repro_torch.core.materializer import H100X4, MeshSpec, Plan  # noqa: E402
from repro_torch.launch.mesh import TorchMesh, make_local_mesh  # noqa: E402
from repro_torch.sharding import collectives as C  # noqa: E402
from repro_torch.sharding.planner import (param_specs_tree,  # noqa: E402
                                          to_layout)
from repro_torch.training import optimizer as opt  # noqa: E402

DGX8 = MeshSpec("dgx8", (2, 4), ("data", "model"))
WORLD_TIMEOUT_S = 150


def run_world(program: str, world: int, d) -> None:
    """``program`` of this module on ``world`` ranks, each in its own
    process; every rank must exit 0 within the timeout."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               program, str(r), str(world), str(d)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            logs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, rc, err[-3000:]) for r, (rc, _, err) in enumerate(logs) if rc]
    assert not bad, bad


@contextlib.contextmanager
def captured_grads(store: list):
    """Each gradient tree the train step hands ``adamw_update`` (averaged
    over the batch, before clipping; on a mesh this rank's slices),
    copied into ``store``."""
    plain = opt.adamw_update

    def spy(grads, *args, **kwargs):
        store.append([g.detach().clone() for g in opt.leaves(grads)])
        return plain(grads, *args, **kwargs)

    opt.adamw_update = spy
    try:
        yield store
    finally:
        opt.adamw_update = plain


@contextlib.contextmanager
def forced_plan(overrides):
    """Every ``Cluster.submit`` in the block places its application under
    the plan with the fields in ``overrides`` replaced: ``launch.serve``
    of a reduced config under a plan its ladder keeps for the full one."""
    from repro_torch.runtime import Cluster
    plain = Cluster.submit

    def submit(self, app, *, overrides=None):
        return plain(self, app, overrides=forced)

    forced = overrides
    Cluster.submit = submit
    try:
        yield
    finally:
        Cluster.submit = plain


def _gathered(tree, layouts):
    return opt.tree_unflatten(tree, [
        C.gather_full(t, lay).clone()
        for t, lay in zip(opt.leaves(tree), opt.leaves(layouts))])


def _block_bytes(lay, specs, under_blocks):
    """The bytes of the compute blocks this rank gathers (the leaves whose
    params layout splits further than their compute layout), of the
    stacked blocks' one block (``under_blocks``) or of the components
    outside them, in bf16."""
    total = 0
    for path, s in _flatten_with_paths(specs):
        if (path.split("/")[0] == "blocks") != under_blocks:
            continue
        lp, lc = (_leaf_at(t, path) for t in (lay.params, lay.compute))
        if lp != lc:
            shape = lc.local_shape(s.shape)
            total += int(torch.tensor(shape[1:] if under_blocks
                                      else shape).prod()) * 2
    return total


def _leaf_at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _step_cases(spec, cases) -> dict:
    """One train step of each case (the mesh ``spec``, the case's plan),
    its gradients and final params gathered whole, with the most bytes of
    gathered compute blocks alive at once in the step and the bounds the
    per-block gathering keeps it to, the gradient sums' local shapes
    beside the optimizer layout's, and the reduce-scatters' routes."""
    from repro_torch.data.pipeline import rank_rows
    from repro_torch.models.model import Model, param_specs
    from repro_torch.training.train_step import (impl_from_plan, layouts_of,
                                                 make_train_step,
                                                 shard_state)
    mesh = TorchMesh(spec)
    out = {}
    for name, case in cases.items():
        plan = Plan(case["cfg"].name, "t", spec, **case["plan"])
        tp = C.tensor_parallel(mesh) if plan.tp else None
        model = Model(case["cfg"], impl_from_plan(plan, mesh), tp=tp)
        lay = layouts_of(model, plan, mesh)
        params, state = shard_state(case["params"], lay)
        batch = case["batch"]
        rows = rank_rows({k: v.float().numpy() if v.is_floating_point()
                          else v.numpy() for k, v in batch.items()},
                         *lay.batch.part(0))
        step = make_train_step(model, plan, case.get("opt"), mesh)
        C.gathered_bytes["peak"] = C.gathered_bytes["live"]
        with captured_grads([]) as grads:
            params, state, m = step(params, state,
                                    {k: torch.from_numpy(v).to(batch[k].dtype)
                                     for k, v in rows.items()})
        specs = param_specs(case["cfg"])
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "grads": [C.gather_full(g, lay_o) for g, lay_o in
                               zip(grads[0], opt.leaves(lay.opt))],
                     "params": _gathered(params, lay.params),
                     "master": _gathered(state["master"], lay.opt),
                     "gathered_peak": C.gathered_bytes["peak"],
                     "block_bytes": _block_bytes(lay, specs, True),
                     "shared_bytes": _block_bytes(lay, specs, False),
                     "sum_shapes": [tuple(g.shape) for g in grads[0]],
                     "opt_shapes": [lo.local_shape(s.shape) for s, lo in zip(
                         opt.leaves(specs), opt.leaves(lay.opt))],
                     "routes": dict(C.reduce_scatter.routes)}
    return out


def sharded_step(rank: int, d: str) -> None:
    """One train step of each case in ``d/steps.pt`` on the (2, 4) mesh
    (:func:`_step_cases`); rank 0 saves the results to
    ``d/steps_out.pt``."""
    out = _step_cases(DGX8, torch.load(os.path.join(d, "steps.pt"),
                                       weights_only=False))
    if rank == 0:
        torch.save(out, os.path.join(d, "steps_out.pt"))


def elastic(rank: int, d: str) -> None:
    """The params of ``d/elastic.pt`` laid out by the TP plan of the (2, 4)
    mesh, saved from the ranks' blocks (rank 0 writes), then restored onto
    the (4, 2) mesh's layout: each rank's block must be bit-equal to its
    block of the whole params, of the (4, 2) layout's shape; every rank
    writes what it found to ``d/elastic_<rank>.pt``."""
    from repro_torch.checkpoint.checkpointer import (restore_checkpoint,
                                                     save_checkpoint)
    case = torch.load(os.path.join(d, "elastic.pt"), weights_only=False)
    cfg, params, specs = case["cfg"], case["params"], case["specs"]
    mesh_a, mesh_b = TorchMesh(DGX8), make_local_mesh(shape=(4, 2))
    lay_a, lay_b = (to_layout(param_specs_tree(
        Plan("t", "train_4k", m.spec, batch_axes=("data",), tp=True), cfg,
        specs), m) for m in (mesh_a, mesh_b))
    local_a = opt.tree_unflatten(params, [
        la.local(p).clone() for p, la in zip(opt.leaves(params),
                                             opt.leaves(lay_a))])
    save_checkpoint(os.path.join(d, "ckpt"), 5, local_a, extra={"mesh": "a"},
                    layouts=lay_a)
    like = opt.tree_unflatten(params, [
        torch.empty(lb.local_shape(p.shape), dtype=p.dtype)
        for p, lb in zip(opt.leaves(params), opt.leaves(lay_b))])
    restored, extra, step = restore_checkpoint(os.path.join(d, "ckpt"), 5,
                                               like, shardings=lay_b)
    want = [lb.local(p) for p, lb in zip(opt.leaves(params),
                                         opt.leaves(lay_b))]
    got = opt.leaves(restored)
    torch.save({"equal": all(torch.equal(a, b) for a, b in zip(got, want)),
                "shapes": [tuple(t.shape) for t in got],
                "want_shapes": [tuple(t.shape) for t in want],
                "specs": [lb.spec for lb in opt.leaves(lay_b)],
                "extra": extra, "step": step,
                "coords": mesh_b.coords},
               os.path.join(d, f"elastic_{rank}.pt"))


def wrong_world(rank: int, d: str) -> None:
    """A plan of the 4-card mesh bound in this world of another size must
    be refused, naming multi-card binding."""
    from repro_torch.runtime import Application, Cluster, TorchExecutor
    c = Cluster(pods=1, mesh=H100X4, executor=TorchExecutor(device="cpu"))
    try:
        c.submit(Application.train("tinyllama-1.1b", reduced=True))
        said = None
    except NotImplementedError as e:
        said = str(e)
    torch.save({"said": said}, os.path.join(d, f"wrong_world_{rank}.pt"))


def world8(rank: int, d: str) -> None:
    sharded_step(rank, d)
    elastic(rank, d)
    wrong_world(rank, d)


def launch_train(rank: int, d: str) -> None:
    """``launch.train`` of each case in ``d/train.pt`` on ``h100x4``
    through ``Cluster.submit`` (the plan's overrides), the final params
    gathered whole; rank 0 saves the metrics, plans and params to
    ``d/train_out.pt``."""
    from repro_torch.launch.train import train
    from repro_torch.models.model import param_specs
    from repro_torch.sharding.planner import plan_layouts
    out = {}
    for name, case in torch.load(os.path.join(d, "train.pt"), weights_only=False).items():
        res = train(case["cfg"], shape=case["shape"],
                    overrides=case["overrides"], opt_cfg=case["opt"],
                    device="cpu", steps=case["steps"], seed=0,
                    mesh="h100x4", dist_backend="gloo", verbose=False)
        mesh = TorchMesh(H100X4)
        lay = plan_layouts(res["plan"], case["cfg"],
                           param_specs(case["cfg"]), mesh)
        out[name] = {"metrics": res["metrics"],
                     "plan": res["plan"].describe(),
                     "grant": res["grant"], "held": res["held"],
                     "local_shapes": [tuple(p.shape) for p in
                                      opt.leaves(res["params"])],
                     "params": _gathered(res["params"], lay.params)}
    if rank == 0:
        torch.save(out, os.path.join(d, "train_out.pt"))


def ep_blocks(rank: int, d: str) -> None:
    """``moe_block`` of each case in ``d/blocks.pt`` over the ``h100x4``
    mesh, (2, 2) over ('data', 'model'): this rank's rows of the case's x
    (the data shard's) and its blocks of the MoE leaves under the
    TP + EP compute layout, under the case's config where it has one;
    its y rows and the aux go to ``d/blocks_<rank>.pt``."""
    from repro_torch.models.moe import moe_block, moe_specs
    from repro_torch.sharding.planner import compute_specs_tree
    blocks = torch.load(os.path.join(d, "blocks.pt"), weights_only=False)
    cfg, mesh = blocks["cfg"], TorchMesh(H100X4)
    plan = Plan(cfg.name, "t", H100X4, batch_axes=("data",), tp=True,
                ep=True)
    lay = to_layout(compute_specs_tree(plan, cfg, moe_specs(cfg)), mesh)
    out = {}
    for name, case in blocks["cases"].items():
        local = opt.tree_unflatten(case["params"], [
            la.local(p) for p, la in zip(opt.leaves(case["params"]),
                                         opt.leaves(lay))])
        x = case["x"]
        rows = x.shape[0] // mesh.size(("data",))
        x = x[mesh.coords["data"] * rows:(mesh.coords["data"] + 1) * rows]
        y, aux = moe_block(local, x, case.get("cfg", cfg),
                           shard_ctx=(mesh, "model", ("data",)),
                           dispatch=case["dispatch"])
        out[name] = {"y": y, "aux": float(aux),
                     "experts": tuple(local["we_gate"].shape)}
    out["routes"] = dict(C.all_to_all.routes)
    torch.save(out, os.path.join(d, f"blocks_{rank}.pt"))


def routing_order(layers: int, remat: str):
    """The layer of each MoE routing of one microbatch, in call order:
    the forward's, then under remat each block's recompute, last block
    first."""
    order = list(range(layers))
    return order + (order[::-1] if remat != "none" else [])


@contextlib.contextmanager
def replayed_routes(replay: list):
    """Each MoE routing takes the next expert ids of ``replay`` (consumed
    in call order) while it lasts, the router's own after: its
    probabilities, weights and balance loss are the run's own, gathered
    at the replayed ids.  A routing is a discrete choice, and one ulp of
    a router logit can swap a near-tied token's experts: the step-1
    gradients are compared on one routing."""
    from repro_torch.models import moe
    plain, pending = moe.route, list(replay)

    def route(p, x, cfg):
        if not pending:
            return plain(p, x, cfg)
        ids = pending.pop(0).to(x.device)
        weights, aux = moe.routed(moe.router_probs(p, x, cfg), ids, cfg,
                                  x.dtype)
        return weights, ids, aux

    moe.route = route
    try:
        yield
    finally:
        moe.route = plain


def rank_routes(table, rows, plan, slices: int, index: int) -> list:
    """This rank's step-1 routings from ``table`` (per layer, the (B, S,
    k) expert ids of every token of the global batch): microbatch i
    routes the rank's global ``rows`` i::mb, flattened row-major, and
    under a2a slice ``index`` of ``slices`` of them."""
    out, mb = [], max(plan["microbatch"], 1)
    for i in range(mb):
        for layer in routing_order(len(table), plan["remat"]):
            ids = table[layer][rows[i::mb]].flatten(0, 1)
            n = ids.shape[0] // slices
            out.append(ids[index * n:(index + 1) * n])
    return out


def ep_train(rank: int, d: str) -> None:
    """``launch.train`` of each case in ``d/ep_train.pt`` on ``h100x4``
    (TP + EP with the case's dispatch, ZeRO and FSDP), step 1 routed to
    the case's ``routes`` (:func:`rank_routes`): the step-1 gradients
    (the first ``adamw_update``'s) and the final params gathered whole,
    saved by rank 0 to ``d/ep_train_out.pt``.  The
    ``restore`` case's final params are then saved from the ranks' blocks
    and restored onto a (4, 1) mesh (each rank's block bit-equal to its
    block of the whole, in ``d/ep_restore_<rank>.pt``) and, on rank 0,
    whole."""
    from repro_torch.checkpoint.checkpointer import (restore_checkpoint,
                                                     save_checkpoint)
    from repro_torch.launch.train import train
    from repro_torch.models.model import param_specs
    from repro_torch.sharding.planner import plan_layouts
    out = {}
    cases = torch.load(os.path.join(d, "ep_train.pt"), weights_only=False)
    mesh = TorchMesh(H100X4)
    for name, case in cases.items():
        rows = torch.arange(case["shape"].global_batch).view(
            mesh.size(("data",)), -1)[mesh.coords["data"]]
        a2a = case["overrides"]["moe_dispatch"] == "a2a"
        replay = rank_routes(case["routes"], rows, case["overrides"],
                             mesh.size(("model",)) if a2a else 1,
                             mesh.coords["model"] if a2a else 0)
        with captured_grads([]) as grads, replayed_routes(replay):
            res = train(case["cfg"], shape=case["shape"],
                        overrides=case["overrides"], opt_cfg=case["opt"],
                        device="cpu", steps=case["steps"], seed=0,
                        mesh="h100x4", dist_backend="gloo", verbose=False)
        specs = param_specs(case["cfg"])
        lay = plan_layouts(res["plan"], case["cfg"], specs, mesh)
        out[name] = {"metrics": res["metrics"],
                     "plan": res["plan"].describe(),
                     "local_shapes": [tuple(p.shape) for p in
                                      opt.leaves(res["params"])],
                     "grads": [C.gather_full(g, lo) for g, lo in
                               zip(grads[0], opt.leaves(lay.opt))],
                     "params": _gathered(res["params"], lay.params)}
        if not case.get("restore"):
            continue
        ckpt = os.path.join(d, "ep_ckpt")
        save_checkpoint(ckpt, 3, res["params"], extra={"plan": name},
                        layouts=lay.params)
        mesh41 = make_local_mesh(shape=(4, 1))
        lay41 = plan_layouts(Plan(case["cfg"].name, "t", mesh41.spec,
                                  **{k: res["plan"].describe()[k] for k in
                                     ("batch_axes", "tp", "ep", "zero",
                                      "fsdp")}),
                             case["cfg"], specs, mesh41).params
        like = opt.tree_unflatten(specs, [
            torch.empty(l41.local_shape(s.shape), dtype=torch.bfloat16)
            for s, l41 in zip(opt.leaves(specs), opt.leaves(lay41))])
        restored, _, _ = restore_checkpoint(ckpt, 3, like, shardings=lay41)
        whole = opt.leaves(out[name]["params"])
        equal = [torch.equal(r, l41.local(w)) for r, w, l41 in zip(
            opt.leaves(restored), whole, opt.leaves(lay41))]
        one = None
        if rank == 0:
            got, _, _ = restore_checkpoint(ckpt, 3, opt.tree_map(
                lambda s: torch.empty(s.shape, dtype=torch.bfloat16),
                specs))
            one = all(torch.equal(a, b)
                      for a, b in zip(opt.leaves(got), whole))
        torch.save({"equal": equal, "one": one,
                    "specs": [l41.spec for l41 in opt.leaves(lay41)]},
                   os.path.join(d, f"ep_restore_{rank}.pt"))
    if rank == 0:
        torch.save(out, os.path.join(d, "ep_train_out.pt"))


def expert_parallel(rank: int, d: str) -> None:
    ep_blocks(rank, d)
    ep_train(rank, d)


def deep_sharded(rank: int, d: str) -> None:
    """One train step of each case in ``d/deep.pt`` on ``h100x4``, (2, 2)
    over ('data', 'model') (:func:`_step_cases`); rank 0 saves the results
    to ``d/deep_out.pt``."""
    out = _step_cases(H100X4, torch.load(os.path.join(d, "deep.pt"),
                                         weights_only=False))
    if rank == 0:
        torch.save(out, os.path.join(d, "deep_out.pt"))


def _serve_decode(model, params, cache, feed, pos0):
    """``make_decode_step`` over the fed tokens (B, steps) from ``pos0``,
    this rank's lanes of them -> (each step's logits, every lane's, on
    this rank; its next tokens; the cache)."""
    from repro_torch.models.model import lane_block
    from repro_torch.serving.serve_step import make_decode_step
    n, i = lane_block(model.lanes)
    per = feed.shape[0] // n
    step, logits, nxt = make_decode_step(model), [], []
    for j in range(feed.shape[1]):
        tok, lg, cache = step(params, feed[i * per:(i + 1) * per, j:j + 1],
                              cache, pos0 + j)
        logits.append(lg)
        nxt.append(tok)
    return torch.stack(logits), torch.stack(nxt), cache


def _local_cache(model, cache):
    """This rank's blocks of the whole cache tree ``cache`` under the
    model's serving layout (the reference test's ``device_put`` of one
    device's cache onto the mesh), copied."""
    lay = model.cache_layouts
    return {key: {k: lay[key][k].local(t).clone() for k, t in leaf.items()}
            for key, leaf in cache.items()}


def _whole_cache(model, cache):
    """Every rank's blocks of ``model``'s cache put together, on every
    rank."""
    lay = model.cache_layouts
    return {key: {k: C.gather_full(t, lay[key][k]) for k, t in leaf.items()}
            for key, leaf in cache.items()}


def _local_params(params, layouts):
    return opt.tree_unflatten(params, [
        lay.local(p).clone() for p, lay in zip(opt.leaves(params),
                                               opt.leaves(layouts))])


def _refusal(fn):
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return None


def sharded_serving(rank: int, d: str) -> None:
    """The cases of ``d/serving.pt`` on ``h100x4`` (rank's lanes, its
    blocks of the weights and the cache): the sequence-sharded decode
    from the one-process prefill's cache (``seqshard``), the TP prefill
    and decode under the ladder's plan (``tp``), ``launch.serve`` through
    ``Cluster.submit`` (``serve``) and the refusals; each rank saves what
    it returned to ``d/serving_<rank>.pt``."""
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import (Model, gather_lanes, lane_block,
                                          param_specs)
    from repro_torch.runtime import (Application, Cluster, ServeOptions,
                                     TorchExecutor)
    from repro_torch.serving.serve_step import (impl_from_plan,
                                                make_prefill_step)
    from repro_torch.sharding.planner import ServeLayout
    cases = torch.load(os.path.join(d, "serving.pt"), weights_only=False)
    mesh, out = TorchMesh(H100X4), {}
    for name, case in cases["seqshard"].items():
        cfg, plan = case["cfg"], case["plan"]
        layout = ServeLayout(plan, mesh)
        model = Model(cfg, impl_from_plan(plan, mesh), layout=layout)
        params = _local_params(case["params"],
                               layout.params(cfg, param_specs(cfg)))
        cache = _local_cache(model, case["cache"])
        logits, nxt, cache = _serve_decode(model, params, cache,
                                           case["feed"], case["pos"])
        out[name] = {"logits": logits, "next": nxt,
                     "cache": _whole_cache(model, cache),
                     "lanes": lane_block(model.lanes),
                     "cache_shape": tuple(cache["p0_attn_global"]["k"].shape)}
    for name, case in cases["tp"].items():
        cfg, plan, cl = case["cfg"], case["plan"], case["cache_len"]
        layout = ServeLayout(plan, mesh)
        model = Model(cfg, impl_from_plan(plan, mesh), layout=layout)
        params = _local_params(case["params"],
                               layout.params(cfg, param_specs(cfg)))
        prompt = case["prompt"]
        n = mesh.size(plan.batch_axes)
        per = prompt.shape[0] // n
        rows = prompt[mesh.index(plan.batch_axes) * per:][:per]
        if case["dtype"] == torch.bfloat16:
            first, cache = make_prefill_step(model, cl)(params, rows)
        else:
            cache = model.init_cache(prompt.shape[0], cl, "cpu",
                                     case["dtype"])
            first, cache = model.prefill(params, rows, cl, cache=cache)
            first = gather_lanes(first, model.lanes)
        logits, nxt, cache = _serve_decode(model, params, cache,
                                           case["feed"], prompt.shape[1])
        out[name] = {"first": first, "logits": logits, "next": nxt,
                     "cache": _whole_cache(model, cache),
                     "wq": tuple(params["blocks"][next(iter(
                         params["blocks"]))]["attn"]["wq"].shape),
                     "cache_k": tuple(next(iter(cache.values()))["k"].shape)}
    sv = cases["serve"]

    def served(arch, overrides=None):
        with forced_plan(overrides):
            return serve(arch, backend="dense",
                         reduced=isinstance(arch, str), device="cpu",
                         requests=sv["requests"], max_batch=sv["max_batch"],
                         prompt_range=sv["prompt_range"],
                         max_new=sv["max_new"], verbose=False,
                         mesh="h100x4", dist_backend="gloo")

    res = served(sv["arch"])
    out["serve"] = {"tokens": {r.req_id: r.output_tokens
                               for r in res["requests"]},
                    "local_prefills": res["runner"].local_prefills,
                    "plan": res["plan"].describe(),
                    "wq": tuple(res["runner"].params["blocks"][
                        "p0_attn_global"]["attn"]["wq"].shape)}
    # weight-gathered (FSDP) serve plans, refused until ROADMAP item A8d's
    # part 5: command-r-35b and dbrx-132b (at widths whose leaves FSDP
    # splits) with the plan's fsdp set
    out["fsdp"] = {}
    for what, arch in (("fsdp", sv["arch"]), ("dbrx_fsdp", sv["dbrx"])):
        res = served(arch, {"fsdp": True})
        out["fsdp"][what] = {
            "tokens": {r.req_id: r.output_tokens for r in res["requests"]},
            "plan": res["plan"].describe(),
            "gathers": res["runner"].model.gather_bytes()}

    def submit(arch, backend="dense", mesh_spec=H100X4, overrides=None):
        c = Cluster(pods=1, mesh=mesh_spec,
                    executor=TorchExecutor(device="cpu"))
        c.submit(Application.serve(arch, reduced=True,
                                   serve=ServeOptions(backend=backend)),
                 overrides=overrides)

    out["refused"] = {
        "paged": _refusal(lambda: submit("command-r-35b", "paged")),
        "world": _refusal(lambda: submit("command-r-35b", mesh_spec=DGX8))}
    try:
        submit("whisper-base")
        out["whisper"] = None
    except Exception as e:     # the dense runner's encoder-decoder refusal
        out["whisper"] = (type(e).__name__, str(e))
    torch.save(out, os.path.join(d, f"serving_{rank}.pt"))


def sharded_families(rank: int, d: str) -> None:
    """The cases of ``d/families.pt`` on ``h100x4`` under their plans
    (TP, the lanes over 'data'; an MoE stack's experts over 'model'; under
    FSDP the weights stored split over 'data' as well): this rank's lanes
    of the prompt (and of the image features or the encoder's frames),
    its blocks of the weights (the stored layout's) and the cache; the
    prefill (in bf16 through ``make_prefill_step``, in fp32 into a cache
    of fp32), then the fed decode steps; each rank saves every lane's
    logits and next tokens, the whole cache, its own cache leaves' shapes,
    its stored weight bytes and the most gathered bytes alive at once
    beside what ``Model.gather_bytes`` accounts to
    ``d/families_<rank>.pt``."""
    from repro_torch.models.model import Model, gather_lanes, param_specs
    from repro_torch.serving.serve_step import (impl_from_plan,
                                                make_prefill_step)
    from repro_torch.sharding.planner import ServeLayout
    cases = torch.load(os.path.join(d, "families.pt"), weights_only=False)
    mesh, out = TorchMesh(H100X4), {}
    for name, case in cases.items():
        cfg, plan, cl = case["cfg"], case["plan"], case["cache_len"]
        layout = ServeLayout(plan, mesh)
        model = Model(cfg, impl_from_plan(plan, mesh), layout=layout)
        params = _local_params(case["params"],
                               layout.params(cfg, param_specs(cfg)))
        prompt, img = case["prompt"], case["img"]
        per = prompt.shape[0] // mesh.size(plan.batch_axes)
        lanes = slice(mesh.index(plan.batch_axes) * per,
                      (mesh.index(plan.batch_axes) + 1) * per)
        rows = prompt[lanes]
        img = None if img is None else img[lanes].to(case["dtype"])
        enc = case.get("enc")
        enc = None if enc is None else enc[lanes].to(case["dtype"])
        C.gathered_bytes["peak"] = C.gathered_bytes["live"]
        if case["dtype"] == torch.bfloat16:
            first, cache = make_prefill_step(model, cl)(params, rows, img,
                                                        enc_feats=enc)
        else:
            cache = model.init_cache(prompt.shape[0], cl, "cpu",
                                     case["dtype"])
            first, cache = model.prefill(params, rows, cl, cache=cache,
                                         img_feats=img, enc_feats=enc)
            first = gather_lanes(first, model.lanes)
        shapes = {key: {k: tuple(t.shape) for k, t in leaf.items()}
                  for key, leaf in cache.items()}
        logits, nxt, cache = _serve_decode(model, params, cache,
                                           case["feed"], case["pos"])
        itemsize = case["dtype"].itemsize
        out[name] = {"first": first, "logits": logits, "next": nxt,
                     "cache": _whole_cache(model, cache),
                     "cache_shapes": shapes,
                     "ep": model.impl.ep_shard_ctx is not None,
                     "dispatch": model.impl.moe_dispatch,
                     "stored": {path: tuple(t.shape) for path, t in
                                _flatten_with_paths(params)},
                     "gathered_peak": C.gathered_bytes["peak"]
                     - C.gathered_bytes["live"],
                     "gather_bytes": model.gather_bytes(itemsize)}
    torch.save(out, os.path.join(d, f"families_{rank}.pt"))


PROGRAMS = {"world8": world8, "launch_train": launch_train,
            "expert_parallel": expert_parallel,
            "deep_sharded": deep_sharded,
            "sharded_serving": sharded_serving,
            "sharded_families": sharded_families}


def main(argv) -> None:
    program, rank, world, d = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world)
    try:
        PROGRAMS[program](rank, d)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)          # the other ranks would wait on this one
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

