"""Rank programs of ``tests/test_torch_distributed.py``.

Each rank of a world runs in its own process::

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
import sys
import traceback

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.materializer import H100X4, MeshSpec, Plan  # noqa: E402
from repro_torch.launch.mesh import TorchMesh, make_local_mesh  # noqa: E402
from repro_torch.sharding import collectives as C  # noqa: E402
from repro_torch.sharding.planner import (param_specs_tree,  # noqa: E402
                                          to_layout)
from repro_torch.training import optimizer as opt  # noqa: E402

DGX8 = MeshSpec("dgx8", (2, 4), ("data", "model"))


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


def _gathered(tree, layouts):
    return opt.tree_unflatten(tree, [
        C.gather_full(t, lay).clone()
        for t, lay in zip(opt.leaves(tree), opt.leaves(layouts))])


def sharded_step(rank: int, d: str) -> None:
    """One train step of each case in ``d/steps.pt`` on the (2, 4) mesh
    (the step's own layouts, the case's plan), its gradients and final
    params gathered whole; rank 0 saves them with the metrics to
    ``d/steps_out.pt``."""
    from repro_torch.models.model import Model
    from repro_torch.training.train_step import (impl_from_plan, layouts_of,
                                                 make_train_step,
                                                 shard_state)
    from repro_torch.data.pipeline import rank_rows
    mesh = TorchMesh(DGX8)
    out = {}
    for name, case in torch.load(os.path.join(d, "steps.pt"), weights_only=False).items():
        plan = Plan(case["cfg"].name, "t", DGX8, **case["plan"])
        tp = C.tensor_parallel(mesh) if plan.tp else None
        model = Model(case["cfg"], impl_from_plan(plan), tp=tp)
        lay = layouts_of(model, plan, mesh)
        params, state = shard_state(case["params"], lay)
        rows = rank_rows({k: v.numpy() for k, v in case["batch"].items()},
                         *lay.batch.part(0))
        step = make_train_step(model, plan, case.get("opt"), mesh)
        with captured_grads([]) as grads:
            params, state, m = step(params, state,
                                    {k: torch.from_numpy(v)
                                     for k, v in rows.items()})
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "grads": [C.gather_full(g, lay_o) for g, lay_o in
                               zip(grads[0], opt.leaves(lay.opt))],
                     "params": _gathered(params, lay.params),
                     "master": _gathered(state["master"], lay.opt)}
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


PROGRAMS = {"world8": world8, "launch_train": launch_train}


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

