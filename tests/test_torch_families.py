"""phi-3-vision-4.2b and whisper-base in the port against the JAX package,
on CPU, and what the three families of this slice share.

The plain versions of K2 and K4 at phi-3's head dim 96 against the
reference's Pallas kernels (interpreted) and oracles; whisper's pieces
(``layer_norm``, the tanh-GELU ``mlp``, cross attention at Sq != Sk,
the encoder) and both models' serving entry points on bridged weights
(whisper with its frame features, phi-3 with image tokens and decode at
``S + num_image_tokens``); phi-3's text prompts through both packages'
``Cluster``s; the reference's prefill/decode consistency rule for the
four reduced configs of the slice; the full configs' parameter counts;
and the refusals (whisper on the dense runner, the three families on the
paged runner and in training).

Tolerances: fp32 2e-5 (summation order), bf16 rtol/atol 2e-2 (the two
frameworks round bf16 at other places); tokens equal except where the
port's top-2 logit gap is below ``TIE_GAP``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core.profiles import model_param_count as jax_param_count
from repro.kernels import ops, ref
from repro.kernels.flash_attention import flash_attention_fwd as jax_fwd
from repro.models import attention as jattn
from repro.models import build_model
from repro.models import layers as JL
from repro.models.transformer import ImplConfig as JaxImpl
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.profiles import model_param_count
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref,
                                                  decode_split_ref)
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_fwd_ref,
                                                 fwd_block_k)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as L
from repro_torch.models.model import Model, init_params
from repro_torch.models.transformer import ImplConfig
from repro_torch.serving.model_runner import DenseRunner, PagedRunner

from test_torch_moe import near_tie_equal, serve_both

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SLICE = ["qwen2-moe-a2.7b", "dbrx-132b", "phi-3-vision-4.2b", "whisper-base"]


def pair(a, dtype="float32"):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a).astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                             else np.float32)
    return jnp.asarray(a), tensor_from_numpy(a, torch.device("cpu"))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def cfgs(arch):
    return (jax_reduced(jax_get_config(arch)),
            reduced_config(get_config(arch)))


def _bridged(arch, seed=0):
    """Reduced configs; the reference's params with every leaf perturbed
    (nonzero norm biases too), as JAX arrays and bridged into the port."""
    jcfg, tcfg = cfgs(arch)
    jparams = build_model(jcfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    host = jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.standard_normal(a.shape) * 0.05).astype(a.dtype),
        jax.tree.map(np.asarray, jparams))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, host),
            params_from_jax(host, tcfg, "cpu"))


def _frontend(cfg, rng, b):
    """Seeded stub inputs: image embeddings (B, N, 1024) or frame
    features (B, T, d), bf16, as a JAX and a torch pair of kwargs."""
    if cfg.family == "vlm":
        j, t = pair(rng.standard_normal((b, cfg.num_image_tokens, 1024)),
                    "bfloat16")
        return {"img_feats": j}, {"img_feats": t}
    if cfg.is_encdec:
        j, t = pair(rng.standard_normal((b, cfg.encoder_seq_len,
                                         cfg.d_model)), "bfloat16")
        return {"enc_feats": j}, {"enc_feats": t}
    return {}, {}


# ---------------------------------------------------------------------------
# K2 and K4 at head dim 96: the plain versions against the reference
# ---------------------------------------------------------------------------

def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fwd_d96_matches_pallas(causal):
    """phi-3's prefill head shape (G = 1, D = 96), causal and not.  fp32:
    the plain version and the kernel's tile form against the Pallas
    forward (interpreted) and the oracle, o and lse within 2e-5.  bf16
    operands (the tensor-core kernel's rounding of p): within 1e-2
    relative norm of the Pallas forward on the same values."""
    rng = np.random.default_rng(96 + causal)
    b, h, s, d = 1, 4, 192, 96
    q, k, v = (_f32(rng, b, h, s, d) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    o_j, lse_j = jax_fwd(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    np.testing.assert_allclose(
        o_j, np.asarray(ref.flash_attention_ref(jq, jk, jv, causal=causal)),
        **TOL["float32"])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for o, lse in (flash_attention_fwd(tq, tk, tv, causal=causal),
                   flash_attention_fwd_ref(tq, tk, tv, causal=causal,
                                           operand_dtype=torch.float32,
                                           block_k=fwd_block_k(d))):
        np.testing.assert_allclose(o.numpy(), o_j, **TOL["float32"])
        np.testing.assert_allclose(lse.numpy(), lse_j, **TOL["float32"])
    qb, kb, vb = (t.to(torch.bfloat16) for t in (tq, tk, tv))
    o_jb, _ = jax_fwd(*(jnp.asarray(t.float().numpy()) for t in (qb, kb, vb)),
                      causal=causal, block_q=64, block_k=64)
    o, _ = flash_attention_fwd_ref(qb, kb, vb, causal=causal,
                                   operand_dtype=torch.bfloat16,
                                   block_k=fwd_block_k(d))
    o_jb = np.asarray(o_jb)
    assert (np.linalg.norm(o.float().numpy() - o_jb)
            / np.linalg.norm(o_jb)) <= 1e-2


@pytest.mark.parametrize("h,kvh,s,d,vlens", [
    (4, 4, 256, 96, (0, 1, 100, 256)),       # phi-3: G = 1, D = 96
    (8, 8, 300, 64, (300, 300, 300, 300)),   # whisper's cross decode
])
def test_decode_attention_d96_and_cross_match_pallas(h, kvh, s, d, vlens):
    """phi-3's dense decode head shape (G = 1, D = 96) with lanes of valid
    length 0, 1, 100 and all, and whisper's cross decode (every lane over
    all the encoder's frames, a frame count that is no multiple of the
    kernel's split unit): the plain version and the kernel's split form
    against the Pallas decode kernel (interpreted) and the oracle, fp32,
    within 2e-5."""
    rng = np.random.default_rng(h + s + d)
    b = len(vlens)
    q, k, v = _f32(rng, b, h, d), _f32(rng, b, kvh, s, d), \
        _f32(rng, b, kvh, s, d)
    vlen = np.asarray(vlens, np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, vlen)]
    pallas = np.asarray(ops.decode_attention(*jargs, block_s=64 if s % 64
                                             == 0 else 60))
    live = vlen > 0
    np.testing.assert_allclose(
        pallas[live], np.asarray(ref.decode_attention_ref(*jargs))[live],
        **TOL["float32"])
    targs = [torch.from_numpy(a) for a in (q, k, v, vlen)]
    got = decode_attention(*targs)
    assert torch.equal(got, decode_attention_ref(*targs))
    np.testing.assert_allclose(got[live].numpy(), pallas[live],
                               **TOL["float32"])
    for kps in (64, 128):
        np.testing.assert_allclose(
            decode_split_ref(*targs, keys_per_split=kps)[live].numpy(),
            pallas[live], **TOL["float32"])


# ---------------------------------------------------------------------------
# whisper's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_mlp_match_reference(dtype):
    """``layer_norm`` (fp32 statistics, gain and bias as they are) and the
    biased MLP with the tanh GELU against the reference's."""
    rng = np.random.default_rng(5)
    xj, xt = pair(rng.standard_normal((3, 7, 64)) * 2 + 0.5, dtype)
    gj, gt = pair(1 + rng.standard_normal(64) * 0.1, dtype)
    bj, bt = pair(rng.standard_normal(64) * 0.1, dtype)
    close(L.layer_norm(xt, gt, bt), JL.layer_norm(xj, gj, bj, eps=1e-5),
          TOL[dtype])
    p = {"wi": (64, 128), "bi": (128,), "wo": (128, 64), "bo": (64,)}
    pj, pt = {}, {}
    for name, shape in p.items():
        pj[name], pt[name] = pair(rng.standard_normal(shape) * 0.2, dtype)
    close(L.mlp(pt, xt), JL.mlp(pj, xj), TOL[dtype])


def test_cross_attention_matches_reference():
    """whisper's cross attention: 12 query rows over 40 encoder frames,
    non-causal (K2's plain version at Sq != Sk), on bridged decoder
    weights, bf16."""
    jcfg, tcfg, jparams, tparams = _bridged("whisper-base")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["p0_dec_attn"]["attn"])
    tp = {k: t[0] for k, t in tparams["blocks"]["p0_dec_attn"]["attn"].items()}
    rng = np.random.default_rng(6)
    xj, xt = pair(rng.standard_normal((2, 12, tcfg.d_model)), "bfloat16")
    ej, et = pair(rng.standard_normal((2, 40, tcfg.d_model)), "bfloat16")
    want = jattn.cross_attention(jp, xj, jattn.encode_cross_kv(jp, ej), jcfg)
    got = tattn.cross_attention(tp, xt, tattn.encode_cross_kv(tp, et), tcfg)
    close(got, want, TOL["bfloat16"])


def test_whisper_encoder_matches_reference():
    """The encoder over seeded frame features: sinusoidal positions, the
    bidirectional layers, ``ln_f``; bf16."""
    jcfg, tcfg, jparams, tparams = _bridged("whisper-base")
    jf, tf = _frontend(tcfg, np.random.default_rng(7), 2)
    want = build_model(jcfg, JaxImpl(remat="none"))._encoder(
        jparams, jf["enc_feats"])
    got = Model(tcfg)._encoder(tparams, tf["enc_feats"])
    assert got.shape == (2, tcfg.encoder_seq_len, tcfg.d_model)
    close(got, want, TOL["bfloat16"])


# ---------------------------------------------------------------------------
# the serving entry points with the frontends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-base", "phi-3-vision-4.2b"])
def test_prefill_and_decode_logits_match_reference(arch):
    """``Model.prefill`` with the stub frontend's inputs (whisper's frame
    features; phi-3's image embeddings, prepended) over 2 prompts of 20
    tokens, then 3 decode steps from position ``20 + num_image_tokens``:
    logits within the bf16 tolerance of the reference's, on bridged
    weights, and the decode cache's cross K/V the reference's."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    jmodel = build_model(jcfg, JaxImpl(remat="none"))
    model = Model(tcfg, ImplConfig(remat="none"))
    rng = np.random.default_rng(8)
    toks = rng.integers(0, tcfg.vocab_size, (2, 23))
    jf, tf = _frontend(tcfg, rng, 2)
    want, jcache = jmodel.prefill(
        jparams, dict(jf, tokens=jnp.asarray(toks[:, :20], jnp.int32)), 48)
    got, cache = model.prefill(tparams, torch.from_numpy(toks[:, :20]), 48,
                               **tf)
    close(got, want, TOL["bfloat16"])
    if tcfg.is_encdec:
        for leaf in ("cross_k", "cross_v"):
            close(cache["p0_dec_attn"][leaf], jcache["p0_dec_attn"][leaf],
                  TOL["bfloat16"])
    pos = 20 + tcfg.num_image_tokens
    for i in range(3):
        want, jcache = jmodel.decode_step(
            jparams, jnp.asarray(toks[:, 20 + i:21 + i], jnp.int32), jcache,
            jnp.asarray(pos + i, jnp.int32))
        got, cache = model.decode_step(
            tparams, torch.from_numpy(toks[:, 20 + i:21 + i]), cache,
            pos + i)
        close(got, want, TOL["bfloat16"])


def test_phi3_text_serving_matches_reference_cluster():
    """phi-3-vision's text prompts (the dense runner passes tokens only, as
    the reference's) through both packages' ``Cluster``s on the dense
    backend: 4 requests of 9..130 tokens, 6 new each."""
    rng = np.random.default_rng(9)
    prompts = [tuple(int(t) for t in rng.integers(0, 256, n))
               for n in (9, 130, 77, 40)]
    want, got, margins, stats = serve_both("phi-3-vision-4.2b", prompts, 6)
    assert stats["completed"] == 4
    assert near_tie_equal(want, got, margins) <= 1


@pytest.mark.parametrize("arch", SLICE)
def test_prefill_decode_consistency(arch):
    """The reference's rule (``tests/test_arch_smoke.py``) on the port:
    a decode step after prefill(S) gives prefill(S+1)'s last logits within
    rtol 0.15 / atol 0.3, the same argmax in at least 95% of the lanes
    (random weights from seed 0, B = 2, S = 16)."""
    _, tcfg = cfgs(arch)
    model = Model(tcfg, ImplConfig(remat="none"))
    params = init_params(tcfg, 0, "cpu")
    rng = np.random.default_rng(10)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 17)))
    _, tf = _frontend(tcfg, rng, 2)
    _, cache = model.prefill(params, toks[:, :16], 32, **tf)
    dec, _ = model.decode_step(params, toks[:, 16:], cache,
                               16 + tcfg.num_image_tokens)
    full, _ = model.prefill(params, toks, 33, **tf)
    a, b = dec[:, -1].numpy(), full[:, -1].numpy()
    np.testing.assert_allclose(a, b, rtol=0.15, atol=0.3)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.95


@pytest.mark.parametrize("arch,lo,hi", [
    ("qwen2-moe-a2.7b", 12e9, 18e9), ("dbrx-132b", 120e9, 145e9),
    ("phi-3-vision-4.2b", 3.4e9, 4.5e9), ("whisper-base", 0.05e9, 0.12e9)])
def test_full_width_param_counts_match_reference(arch, lo, hi):
    """The ranges of ``tests/test_arch_smoke.py``; the counts are exactly
    the reference's (the padded experts, the image projection and the
    encoder included)."""
    n = model_param_count(get_config(arch))
    assert n == jax_param_count(jax_get_config(arch))
    assert lo <= n <= hi


# ---------------------------------------------------------------------------
# what the port refuses, and says why
# ---------------------------------------------------------------------------

def test_whisper_is_refused_by_the_dense_runner():
    """The runner passes a prompt's tokens only; whisper's prefill needs
    its frames (the reference fails with a KeyError at the first
    prefill), so the port refuses at construction."""
    _, tcfg = cfgs("whisper-base")
    with pytest.raises(ValueError, match="enc_feats"):
        DenseRunner(tcfg, device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "phi-3-vision-4.2b",
                                  "whisper-base"])
def test_paged_runner_and_training_refuse_the_families(arch, monkeypatch):
    """The paged runner refuses all three families, as the reference's
    does.  Each trains: one ``make_train_step`` step of the reduced config
    with its frontend's seeded inputs gives a finite loss and moves the
    params.  ``launch.train`` (``Cluster.submit``, whose batches hold
    tokens and labels only) trains the MoE family and phi-3-vision's text
    one step, and refuses whisper, naming ``enc_feats``, before any
    weights are made."""
    from repro_torch.core.materializer import H100, Plan
    from repro_torch.launch.train import train
    from repro_torch.runtime import TorchExecutor
    from repro_torch.training import optimizer as topt
    from repro_torch.training.train_step import make_train_step
    _, tcfg = cfgs(arch)
    with pytest.raises(ValueError, match="paged"):
        PagedRunner(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 12)))
    batch = dict({"tokens": toks, "labels": toks.roll(-1, 1)},
                 **_frontend(tcfg, rng, 2)[1])
    params = init_params(tcfg, 0, "cpu")
    step = make_train_step(Model(tcfg, ImplConfig(remat="full")),
                           Plan(tcfg.name, "t", H100, microbatch=1))
    new, _, m = step(params, topt.init_opt_state(params), batch)
    assert np.isfinite(float(m["loss"]))
    assert any(not torch.equal(a, b) for a, b in
               zip(topt.leaves(params), topt.leaves(new)))
    if not tcfg.is_encdec:
        out = train(arch, reduced=True, device="cpu", steps=1, verbose=False)
        assert np.isfinite(out["metrics"][0]["loss"])
        return
    made = []
    monkeypatch.setattr(TorchExecutor, "init_params",
                        lambda self, handle: made.append(handle))
    with pytest.raises(ValueError, match="enc_feats"):
        train(arch, reduced=True, device="cpu", steps=1, verbose=False)
    assert made == []