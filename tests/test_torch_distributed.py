"""The port's sharded training against the JAX package's, on the CPU.

The counterpart of ``tests/test_distributed.py``'s
``test_sharded_train_step_matches_single_device`` and
``test_elastic_restore_onto_different_mesh``: where the reference forces
8 host devices and lets its partitioner shard a jitted step, the port
runs a ``torch.distributed`` world of CPU processes over gloo
(``tests/torch_ranks.py``, one process a rank, a ``file://`` rendezvous
in a temporary directory, each world under a timeout) and its sharded
step with the collectives written out.  Two worlds in all: 8 ranks on
the (2, 4) mesh (the reference test's step, elastic restore, binding in
a world of the wrong size) and 4 ranks on ``h100x4`` (``launch.train``
through ``Cluster.submit`` with both of its training plans).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core.materializer import MeshSpec as JaxMeshSpec
from repro.core.materializer import Plan as JaxPlan
from repro.models import ImplConfig as JaxImplConfig
from repro.models import build_model
from repro.training import optimizer as jopt
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint.checkpointer import (_flatten_with_paths,
                                                 restore_checkpoint)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.materializer import H100X4, MeshSpec, Plan
from repro_torch.launch.train import train
from repro_torch.models.model import Model, init_params, param_specs
from repro_torch.models.transformer import ImplConfig
from repro_torch.runtime import Application, Cluster, TorchExecutor
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import make_train_step
from torch_ranks import captured_grads, run_world

# the reference test's plan: TP over 'model', ZeRO over 'data'
REF_PLAN = dict(batch_axes=("data",), tp=True, zero=True, remat="none",
                microbatch=1)
# the two plans of launch.train on h100x4 (chip_smoke's phase 20): the
# ladder's own (DP over both axes, ZeRO) and TP + ZeRO + FSDP
TRAIN_PLANS = {
    "ladder": {"remat": "full", "microbatch": 2},
    "tp": {"tp": True, "zero": True, "fsdp": True, "batch_axes": ("data",),
           "remat": "full", "microbatch": 2},
}


def _keys(tree):
    return [key for key, _ in _flatten_with_paths(tree)]


def _reduced_tinyllama(**extra):
    return (jax_reduced(jax_get_config("tinyllama-1.1b"), **extra),
            reduced_config(get_config("tinyllama-1.1b"), **extra))


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """The reference test's inputs (reduced tinyllama-1.1b, PRNGKey(0)
    weights, an (8, 16) batch) through its jitted one-device step, and
    through the port's sharded step on 8 gloo ranks of the (2, 4) mesh,
    bridged; a second case with 2 KV heads (replicated over the 4-way
    model axis, each shared by two ranks' q heads) and a warmed-up
    optimizer, held against the port's one-device step only."""
    d = tmp_path_factory.mktemp("world8")
    jcfg, tcfg = _reduced_tinyllama()
    jmodel = build_model(jcfg, JaxImplConfig(remat="none"))
    rng = jax.random.PRNGKey(0)
    jparams = jmodel.init_params(rng)
    batch = {"tokens": jax.random.randint(rng, (8, 16), 0, jcfg.vocab_size),
             "labels": jax.random.randint(rng, (8, 16), 0, jcfg.vocab_size)}
    jplan = JaxPlan("t", "train_4k", JaxMeshSpec("test", (2, 4),
                                                 ("data", "model")),
                    **REF_PLAN)
    _, jst, jm = jax.jit(jax_make_train_step(jmodel, jplan))(
        jparams, jopt.init_opt_state(jparams), batch)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

    kv_cfg = reduced_config(get_config("tinyllama-1.1b"), num_heads=8,
                            num_kv_heads=2, num_layers=2)
    gen = torch.Generator().manual_seed(3)
    kv_params = topt.tree_map(
        lambda p: (p.float() + 0.02 * torch.randn(p.shape, generator=gen)
                   ).to(torch.bfloat16),
        init_params(kv_cfg, 1, "cpu"))
    kv_opt = topt.OptimizerConfig(warmup_steps=1, peak_lr=1e-2)
    cases = {"ref": {"cfg": tcfg, "plan": REF_PLAN, "params": params,
                     "batch": tbatch},
             "kv2": {"cfg": kv_cfg, "plan": dict(REF_PLAN, microbatch=2),
                     "params": kv_params, "batch": tbatch, "opt": kv_opt},
             "kv2_fp32": {"cfg": kv_cfg, "plan": dict(REF_PLAN, microbatch=2),
                          "params": topt.tree_map(lambda p: p.float(),
                                                  kv_params),
                          "batch": tbatch, "opt": kv_opt}}
    torch.save(cases, d / "steps.pt")
    torch.save({"cfg": tcfg, "params": params, "specs": param_specs(tcfg)},
               d / "elastic.pt")
    run_world("world8", 8, d)
    one = {}
    for name, case in cases.items():
        plan = Plan(case["cfg"].name, "t", MeshSpec("dgx8", (2, 4),
                                                    ("data", "model")),
                    **case["plan"])
        step = make_train_step(Model(case["cfg"], ImplConfig(remat="none")),
                               plan, case.get("opt"))
        with captured_grads([]) as grads:
            p, st, m = step(case["params"],
                            topt.init_opt_state(case["params"]), tbatch)
        one[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "params": p,
                     "grads": grads[0], "params0": case["params"]}
    return {"dir": d, "jax": (jm, jst), "one": one,
            "sharded": torch.load(d / "steps_out.pt", weights_only=False)}


def test_sharded_step_matches_the_reference_step(world8):
    """The reference test's gate, no looser: the loss within 5e-2 of the
    reference's one-device step and every param within rtol = atol =
    8e-2 (fp32 master included)."""
    jm, jst = world8["jax"]
    got = world8["sharded"]["ref"]
    assert abs(got["loss"] - float(jm["loss"])) < 5e-2
    for a, b in zip(topt.leaves(got["master"]),
                    jax.tree.leaves(jst["master"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=8e-2,
                                   atol=8e-2)
    for a, b in zip(topt.leaves(got["params"]),
                    jax.tree.leaves(jst["master"])):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(jnp.asarray(b, jnp.bfloat16),
                                              np.float32),
                                   rtol=8e-2, atol=8e-2)


# (loss, global norm, each gradient leaf): relative tolerances of the
# sharded step against the port's one-device step.  In bf16 TP sums the
# row-parallel products' bf16 partials over the group, about one bf16 ulp
# (4e-3) from the one-card product, and a leaf's gradient moves by up to
# the 2e-2 relative norm the bf16 port-vs-reference tests allow; in fp32
# only the summation order differs.
ONE_DEVICE_TOL = {"ref": (1e-4, 1e-3, 2e-2), "kv2": (1e-4, 1e-3, 2e-2),
                  "kv2_fp32": (1e-6, 1e-5, 1e-4)}


@pytest.mark.parametrize("case", sorted(ONE_DEVICE_TOL))
def test_sharded_step_matches_the_ports_one_device_step(world8, case):
    """Tighter, against the port's own one-device step on the same
    weights and batch (``ONE_DEVICE_TOL``): the loss, the gradient's
    global norm and every gradient leaf (averaged over the batch,
    gathered whole; by relative norm)."""
    one, got = world8["one"][case], world8["sharded"][case]
    loss_tol, norm_tol, grad_tol = ONE_DEVICE_TOL[case]
    assert abs(got["loss"] - one["loss"]) <= loss_tol * abs(one["loss"])
    assert abs(got["grad_norm"] - one["grad_norm"]) <= \
        norm_tol * one["grad_norm"]
    for a, b in zip(got["grads"], one["grads"]):
        assert float((a - b).norm()) <= grad_tol * float(b.norm())


def test_elastic_restore_onto_a_different_mesh(world8):
    """Saved from the (2, 4) mesh's TP layout (rank 0 writes the gathered
    leaves), restored onto (4, 2): each rank's block bit-equal to its
    block of the whole params, shaped by the new mesh (the vocab split in
    2, not 4); restored onto one process: bit-equal to the whole."""
    d, params = world8["dir"], world8["one"]["ref"]["params0"]
    ranks = [torch.load(d / f"elastic_{r}.pt", weights_only=False)
             for r in range(8)]
    for r in ranks:
        assert r["equal"] and r["shapes"] == r["want_shapes"]
        assert r["step"] == 5 and r["extra"] == {"mesh": "a"}
    tok = _keys(params).index("embed/tok")
    assert ranks[0]["specs"][tok] == ("model", None)
    assert ranks[0]["shapes"][tok] == (128, 64)
    assert {r["coords"]["data"] for r in ranks} == {0, 1, 2, 3}
    whole, _, _ = restore_checkpoint(str(d / "ckpt"), 5, params)
    for a, b in zip(topt.leaves(whole), topt.leaves(params)):
        assert torch.equal(a, b)


def test_multi_card_plan_outside_its_world_is_refused(world8):
    """A plan of the 4-card mesh is refused, naming multi-card binding,
    outside any world (here) and inside a world of 8 ranks."""
    c = Cluster(pods=1, mesh=H100X4, executor=TorchExecutor(device="cpu"))
    with pytest.raises(NotImplementedError, match="multi-card"):
        c.submit(Application.train("tinyllama-1.1b", reduced=True))
    for r in range(8):
        said = torch.load(world8["dir"] / f"wrong_world_{r}.pt")["said"]
        assert said is not None and "multi-card" in said and "8 ranks" in said


def _mid_tinyllama():
    """tinyllama-1.1b's pattern at widths whose leaves pass the planner's
    FSDP_MIN_ELEMS, so ZeRO and FSDP split them."""
    return get_config("tinyllama-1.1b").scaled(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=4, head_dim=32,
        d_ff=512, vocab_size=512)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """``launch.train`` of each of ``TRAIN_PLANS`` for 3 steps on 4 gloo
    ranks of ``h100x4`` and on one process (``mesh="h100"``)."""
    d = tmp_path_factory.mktemp("world4")
    cfg, shape = _mid_tinyllama(), ShapeConfig("mid_b8", "train", 32, 8)
    ocfg = topt.OptimizerConfig(warmup_steps=1)        # chip_smoke's
    cases = {name: {"cfg": cfg, "shape": shape, "overrides": ov,
                    "opt": ocfg, "steps": 3}
             for name, ov in TRAIN_PLANS.items()}
    torch.save(cases, d / "train.pt")
    run_world("launch_train", 4, d)
    one = {name: train(cfg, shape=shape, overrides=ov, opt_cfg=ocfg,
                       device="cpu", steps=3, seed=0, verbose=False)
           for name, ov in TRAIN_PLANS.items()}
    return one, torch.load(d / "train_out.pt", weights_only=False)


@pytest.mark.parametrize("name", sorted(TRAIN_PLANS))
def test_launch_train_on_four_ranks_matches_one_process(world4, name):
    """Both plans bind through ``Cluster.submit`` on ``h100x4``: the
    ladder's own DP plan over ('data', 'model') with ZeRO, and TP + ZeRO
    + FSDP over 'data' (its leaves split 8 ways for storage, heads 4 of
    8 on each rank for compute).  Losses within 1e-3 relative and the
    final params within 1e-2 relative norm of the one-process run;
    the grant covers the largest rank's footprint."""
    one, four = world4[0][name], world4[1][name]
    plan = four["plan"]
    if name == "ladder":
        assert (plan["batch_axes"], plan["tp"], plan["zero"],
                plan["fsdp"]) == (("data", "model"), False, True, False)
    else:
        assert (plan["batch_axes"], plan["tp"], plan["zero"],
                plan["fsdp"]) == (("data",), True, True, True)
        wq = _keys(one["params"]).index("blocks/p0_attn_global/attn/wq")
        assert four["local_shapes"][wq] == (2, 256, 2, 32)
    losses = [m["loss"] for m in four["metrics"]]
    want = [m["loss"] for m in one["metrics"]]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want, rtol=1e-3)
    num = sum(float((a.float() - b.float()).square().sum()) for a, b in
              zip(topt.leaves(four["params"]), topt.leaves(one["params"])))
    den = sum(float(b.float().square().sum())
              for b in topt.leaves(one["params"]))
    assert (num / den) ** 0.5 <= 1e-2
    assert four["grant"] >= four["held"] > 0
