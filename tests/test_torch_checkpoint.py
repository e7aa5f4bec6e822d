"""The port's checkpoints against the JAX package's, on CPU.

Both packages write the same on-disk format, so the training state --
params plus ``m``, ``v``, ``master`` and ``count`` -- crosses in either
direction bit for bit, and a cut taken by the port resumes its training
exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import restore_checkpoint as jax_restore
from repro.checkpoint.checkpointer import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.models import build_model
from repro.training import optimizer as jopt
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 latest_step,
                                                 restore_checkpoint,
                                                 save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.launch.train import train
from repro_torch.training import optimizer as topt


def _states():
    """The same {"params", "opt"} training state in both packages: the
    reference's reduced tinyllama-1.1b init, and an optimizer state with
    nonzero moments and a count of 7."""
    jcfg = jax_reduced(jax_get_config("tinyllama-1.1b"))
    tcfg = reduced_config(get_config("tinyllama-1.1b"))
    params = jax.tree.map(np.asarray, build_model(jcfg).init_params(
        jax.random.PRNGKey(0)))
    opt = jax.tree.map(np.asarray, jopt.init_opt_state(params))
    rng = np.random.default_rng(0)
    for key in ("m", "v"):
        opt[key] = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            opt[key])
    opt["count"] = np.asarray(7, np.int32)
    jtree = {"params": params, "opt": opt}
    ttree = {"params": params_from_jax(params, tcfg, "cpu"),
             "opt": topt.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  opt)}
    return jtree, ttree


def _bits(x) -> np.ndarray:
    """The raw bits of a leaf of either package, as an integer array."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        a = x.numpy()
    else:
        a = np.asarray(x)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


def _assert_bit_equal(jtree, ttree):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = topt.leaves(ttree)
    assert len(jflat) == len(tflat)
    for (path, a), b in zip(jflat, tflat):
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=jax.tree_util.keystr(path))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jtree, ttree = _states()
    save_checkpoint(str(tmp_path), 5, ttree, extra={"cursor": 5})
    like = jax.tree.map(jnp.asarray, jtree)
    restored, extra, step = jax_restore(str(tmp_path), None, like)
    assert step == 5 and extra == {"cursor": 5}
    assert restored["params"]["embed"]["tok"].dtype == jnp.bfloat16
    assert restored["opt"]["count"].dtype == jnp.int32
    _assert_bit_equal(restored, ttree)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _states()
    jax_save(str(tmp_path), 9, jax.tree.map(jnp.asarray, jtree),
             extra={"cursor": 9})
    like = topt.tree_map(torch.zeros_like, ttree)
    restored, extra, step = restore_checkpoint(str(tmp_path), None, like)
    assert step == 9 and extra == {"cursor": 9}
    assert restored["params"]["embed"]["tok"].dtype == torch.bfloat16
    assert restored["opt"]["count"].dtype == torch.int32
    _assert_bit_equal(jtree, restored)


def test_both_packages_write_the_same_files(tmp_path):
    """Same leaves, keys, order, dtypes, shapes and file bytes: the two
    manifests are equal."""
    jtree, ttree = _states()
    save_checkpoint(str(tmp_path / "port"), 1, ttree)
    jax_save(str(tmp_path / "ref"), 1, jax.tree.map(jnp.asarray, jtree))
    manifests = [json.load(open(tmp_path / d / "step_00000001" /
                                "manifest.json")) for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    keys = [ent["key"] for ent in manifests[0]["leaves"]]
    assert "opt/count" in keys and "params/ln_f/g" in keys


def test_restore_validates_shapes_and_ignores_uncommitted_cuts(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_00000002.tmp")      # a crash mid-write
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, dict(tree, a=torch.zeros(3, 3)))
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(str(tmp_path), 1, dict(tree, z=torch.zeros(1)))


def test_async_checkpointer_keeps_the_newest_cuts(tmp_path):
    """``keep=2`` leaves the last two cuts; a cut is a copy taken at
    ``save``, unaffected by later in-place updates of the state."""
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    state = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        ck.save(s, state)
        state["w"].add_(1.0)                          # the optimizer's way
    ck.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]
    restored, _, _ = restore_checkpoint(str(tmp_path), 4, state)
    assert restored["w"].tolist() == [3.0, 3.0, 3.0]


def test_resume_from_a_cut_replays_identically(tmp_path):
    """Train 6 steps; separately train to a cut at 3 and resume from it to
    6: the final params and optimizer state are equal bit for bit (the
    port's counterpart of ``test_checkpoint.py``'s recovery test)."""
    kw = dict(reduced=True, device="cpu", verbose=False,
              opt_cfg=topt.OptimizerConfig(peak_lr=1e-2, warmup_steps=2))
    ref = train("tinyllama-1.1b", steps=6, **kw)
    ckpt = str(tmp_path / "ckpt")
    first = train("tinyllama-1.1b", steps=3, ckpt_dir=ckpt, ckpt_every=3,
                  **kw)
    # the executor keeps each application's cuts under its name
    assert latest_step(os.path.join(ckpt, "tinyllama-1.1b:train")) == 3
    assert first["cursor"] == 3
    resumed = train("tinyllama-1.1b", steps=6, ckpt_dir=ckpt, resume=True,
                    **kw)
    assert len(resumed["metrics"]) == 3 and resumed["cursor"] == 6
    np.testing.assert_array_equal(
        [m["loss"] for m in resumed["metrics"]],
        [m["loss"] for m in ref["metrics"][3:]])
    for a, b in zip(topt.leaves({"p": ref["params"], "o": ref["opt_state"]}),
                    topt.leaves({"p": resumed["params"],
                                 "o": resumed["opt_state"]})):
        assert torch.equal(a, b)
