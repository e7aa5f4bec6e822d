"""The port's model layers against the JAX package's, on CPU.

Same inputs from numpy, same (bridged) weights; tolerances fp32 2e-5,
bf16 2e-2 (the two frameworks round bf16 at slightly different places:
XLA rounds after each elementwise op, PyTorch once per fused op).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import layers as JL
from repro.serving.model_runner import build_runner as jax_build_runner
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as TL
from repro_torch.models.model import (embed_tokens, init_params,
                                      param_specs)
from repro_torch.serving.model_runner import PagedRunner

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def pair(a, dtype="float32"):
    a = np.asarray(a)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
    else:
        a = a.astype(np.float32)
    return jnp.asarray(a), tensor_from_numpy(a, torch.device("cpu"))


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def cfgs(**extra):
    """The reduced tinyllama-1.1b config of each package."""
    return (jax_reduced(jax_get_config("tinyllama-1.1b"), **extra),
            reduced_config(get_config("tinyllama-1.1b"), **extra))


def bridged(jparams, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decode", [False, True])
def test_apply_rope_matches_reference(dtype, decode):
    rng = np.random.default_rng(1)
    if decode:        # (B, 1) per-lane positions, as decode passes them
        x = rng.standard_normal((3, 1, 4, 16))
        pos = np.asarray([[5], [700], [129]])
    else:             # (S,) positions from an offset, as prefill chunks do
        x = rng.standard_normal((1, 40, 4, 16))
        pos = 512 + np.arange(40)
    xj, xt = pair(x, dtype)
    got = TL.apply_rope(xt, torch.from_numpy(pos), 10_000.0)
    close(got, JL.apply_rope(xj, jnp.asarray(pos), 10_000.0), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_mlp_matches_reference(dtype):
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s) * 0.1 for k, s in
         (("wi_gate", (32, 48)), ("wi_up", (32, 48)), ("wo", (48, 32)))}
    pj = {k: pair(v, dtype)[0] for k, v in p.items()}
    pt = {k: pair(v, dtype)[1] for k, v in p.items()}
    xj, xt = pair(rng.standard_normal((2, 5, 32)), dtype)
    close(TL.gated_mlp(pt, xt), JL.gated_mlp(pj, xj), dtype)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_qkv_matches_reference(qk_norm, dtype):
    jcfg, tcfg = cfgs(use_qk_norm=qk_norm)
    rng = np.random.default_rng(3)
    d, h, kv, hd = tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, \
        tcfg.head_dim
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "wo": (h, hd, d)}
    if qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    p = {k: rng.standard_normal(s) * 0.1 for k, s in shapes.items()}
    pj = {k: pair(v, dtype)[0] for k, v in p.items()}
    pt = {k: pair(v, dtype)[1] for k, v in p.items()}
    xj, xt = pair(rng.standard_normal((2, 7, d)), dtype)
    pos = 100 + np.arange(7)
    got = tattn.project_qkv(pt, xt, tcfg, torch.from_numpy(pos))
    want = jattn.project_qkv(pj, xj, jcfg, jnp.asarray(pos))
    for g, w in zip(got, want):
        close(g, w, dtype)
    o = rng.standard_normal((2, 7, h, hd))
    close(tattn.attn_out(pt, pair(o, dtype)[1]),
          jattn.attn_out(pj, pair(o, dtype)[0]), dtype)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_unembed_matches_reference(tied, softcap):
    rng = np.random.default_rng(4)
    p = {"tok": rng.standard_normal((50, 16))}
    if not tied:
        p["head"] = rng.standard_normal((16, 50))
    pj = {k: pair(v, "bfloat16")[0] for k, v in p.items()}
    pt = {k: pair(v, "bfloat16")[1] for k, v in p.items()}
    xj, xt = pair(rng.standard_normal((2, 3, 16)), "bfloat16")
    got = TL.unembed(pt, xt, softcap)
    assert got.dtype == torch.float32
    close(got, JL.unembed(pj, xj, softcap), "bfloat16")


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "gemma3-12b"])
def test_embed_matches_reference(name):
    """``_embed`` with gemma's sqrt(d) scale (the reference decides it by
    name, the port by ``scale_embed``)."""
    jcfg = jax_reduced(jax_get_config("tinyllama-1.1b"), name=name)
    tcfg = reduced_config(get_config("tinyllama-1.1b"), name=name,
                          scale_embed=name.startswith("gemma"))
    jmodel = build_model(jcfg)
    rng = np.random.default_rng(5)
    tok = rng.standard_normal((tcfg.vocab_size, tcfg.d_model))
    toks = rng.integers(0, tcfg.vocab_size, (2, 9))
    (tj, tt) = pair(tok, "bfloat16")
    want = jmodel._embed({"embed": {"tok": tj}}, jnp.asarray(toks))
    got = embed_tokens(tcfg, {"embed": {"tok": tt}}, torch.from_numpy(toks))
    close(got, want, "bfloat16")


def test_param_tree_matches_reference_layout():
    """The port's spec tree has the reference's keys and shapes (so the
    bridge is a plain copy), and its torch init follows the reference's
    rules: zero (1+g) gains, std 0.02 matrices."""
    jcfg, tcfg = cfgs()
    jspecs = build_model(jcfg).param_specs()
    jshapes = jax.tree.map(lambda s: s.shape, jspecs, is_leaf=JL.is_spec)
    tshapes = jax.tree.map(lambda s: s.shape, param_specs(tcfg),
                           is_leaf=lambda s: isinstance(s, TL.Spec))
    assert jshapes == tshapes
    params = init_params(tcfg, seed=0, device="cpu")
    assert params["ln_f"]["g"].abs().max().item() == 0.0
    assert params["blocks"]["p0_attn_global"]["ln1"]["g"].abs().max() == 0
    wq = params["blocks"]["p0_attn_global"]["attn"]["wq"].float()
    assert wq.dtype == torch.float32 and abs(wq.std().item() - 0.02) < 2e-3
    again = init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(again["embed"]["tok"], params["embed"]["tok"])


def test_bridge_accepts_both_bf16_forms_and_checks_shapes():
    jcfg, tcfg = cfgs()
    jparams = build_model(jcfg).init_params(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jparams)
    as_bits = jax.tree.map(lambda a: a.view(np.uint16), host)
    a = params_from_jax(host, tcfg, "cpu")
    b = params_from_jax(as_bits, tcfg, "cpu")
    ta, tb = a["embed"]["tok"], b["embed"]["tok"]
    assert ta.dtype == tb.dtype == torch.bfloat16 and torch.equal(ta, tb)
    np.testing.assert_array_equal(ta.float().numpy(),
                                  host["embed"]["tok"].astype(np.float32))
    host["ln_f"]["g"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="ln_f/g"):
        params_from_jax(host, tcfg, "cpu")
    del host["ln_f"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(host, tcfg, "cpu")


def test_bridged_block_forward_matches_reference():
    """One layer of the paged runner (norm, projections, RoPE, causal
    attention, output, norm, MLP) on bridged weights: the reference's
    ``PagedRunner._block_forward`` against the port's."""
    jcfg, tcfg = cfgs()
    jr = jax_build_runner("paged", jcfg, seed=0, pool_pages=4)
    rng = np.random.default_rng(6)
    jparams = jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.standard_normal(a.shape) * 0.05).astype(a.dtype),
        jax.tree.map(np.asarray, jr.params))   # nonzero norm gains too
    tr = PagedRunner(tcfg, pool_pages=4, params=bridged(jparams, tcfg),
                     device="cpu")
    bpj = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       jparams["blocks"]["p0_attn_global"])
    xj, xt = pair(rng.standard_normal((1, 48, tcfg.d_model)), "bfloat16")
    pos = np.arange(48)
    want = jr._block_forward(
        bpj, xj, jnp.asarray(pos),
        lambda q, k, v: jattn.sdpa(q, k, v, causal=True))
    got = tr._block_forward(
        tr.layers[0], xt, torch.from_numpy(pos),
        lambda q, k, v: tattn.sdpa(q, k, v, causal=True))
    close(got, want, "bfloat16")
