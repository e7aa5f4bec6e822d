"""The port's sharding planner against the JAX package's, on the CPU.

Host arithmetic, so every result must be EXACTLY equal: the logical axes
of every parameter leaf (``models.layers.logical_axes`` against the
reference's ``Model.logical_axes``), and the PartitionSpecs of the
params, the optimizer state, the batch, the activations, the dense
cache and the MoE dispatch buffer, leaf by leaf (the port's
``PartitionSpec`` is a tuple; the reference's is compared as one), for
every architecture at full and reduced size, over the port's meshes and
three multi-device meshes, under every plan flag the planner reads.
"""

import itertools

import jax
import pytest
from jax.sharding import PartitionSpec as JaxP

from repro.configs import get_config as jax_get_config
from repro.configs.base import list_archs
from repro.configs.reduced import reduced_config as jax_reduced
from repro.core import materializer as jmat
from repro.models import build_model
from repro.sharding import planner as jplan
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.core import materializer as tmat
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import param_specs
from repro_torch.sharding import planner as tplan

ARCHS = list_archs()
MESHES = [(m.name, m.shape, m.axes) for m in tmat.MESHES.values()] + [
    ("dgx8", (2, 4), ("data", "model")),
    ("pods2x4x4", (2, 4, 4), ("pod", "data", "model")),
    ("pod16x16", (16, 16), ("data", "model")),
]
# every flag the planner reads, alone and in the combinations the ladder
# and the tests bind
FLAGS = [
    {},
    {"tp": False},
    {"tp": True, "zero": True},
    {"tp": True, "zero": True, "fsdp": True},
    {"tp": True, "fsdp": True, "fsdp_contracting": True},
    {"tp": False, "zero": True, "fsdp": False},
    {"tp": True, "ep": True},
    {"tp": True, "ep": True, "fsdp": True},
    {"kv_shard_heads": True},
    {"kv_shard_seq": True},
    {"tp": False, "kv_shard_seq": True},
]
CACHE_SHAPES = [(8, 4096), (1, 512), (3, 100)]


def _cfgs(arch, reduced):
    j, t = jax_get_config(arch), get_config(arch)
    return (jax_reduced(j), reduced_config(t)) if reduced else (j, t)


def _batch_axes(axes):
    """The batch-axes choices of a mesh: none, the first batch-capable
    axis, all of them, all of them and 'model'."""
    capable = tuple(a for a in axes if a != "model")
    return [(), capable[:1], capable, capable + ("model",)]


def _plans(name, shape, axes):
    """Pairs of equal plans in both packages over one mesh."""
    tmesh = tmat.MeshSpec(name, shape, axes)
    jmesh = jmat.MeshSpec(name, shape, axes)
    for flags, batch_axes, seq_axes in itertools.product(
            FLAGS, _batch_axes(axes), [(), ("model",)]):
        kw = dict(flags, batch_axes=batch_axes, seq_axes=seq_axes)
        yield (jmat.Plan("a", "s", jmesh, **kw),
               tmat.Plan("a", "s", tmesh, **kw))


def _as_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, JaxP))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_match_reference(arch, reduced):
    jcfg, tcfg = _cfgs(arch, reduced)
    want = build_model(jcfg).logical_axes()
    got = L.logical_axes(param_specs(tcfg))
    assert got == want


@pytest.mark.parametrize("mesh", MESHES, ids=[m[0] for m in MESHES])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_specs_match_reference(arch, reduced, mesh):
    jcfg, tcfg = _cfgs(arch, reduced)
    jmodel = build_model(jcfg)
    jspecs, tspecs = jmodel.param_specs(), param_specs(tcfg)
    caches = [(jmodel.cache_specs(b, s), T.cache_specs(tcfg, b, s))
              for b, s in CACHE_SHAPES]
    n = 0
    for jp, tp in _plans(*mesh):
        for fn in ("param_specs_tree", "opt_state_specs_tree"):
            want = _as_tuples(getattr(jplan, fn)(jp, jcfg, jspecs))
            assert getattr(tplan, fn)(tp, tcfg, tspecs) == want, (fn, tp)
        for jc, tc in caches:
            assert tplan.cache_specs_tree(tp, tcfg, tc) == \
                _as_tuples(jplan.cache_specs_tree(jp, jcfg, jc))
        for extra in (1, 2):
            assert tplan.batch_spec(tp, extra) == \
                tuple(jplan.batch_spec(jp, extra))
        assert tplan.activation_spec(tp) == tuple(jplan.activation_spec(jp))
        want = jplan.ep_dispatch_spec(jp)
        got = tplan.ep_dispatch_spec(tp)
        assert (got is None) == (want is None) and (
            got is None or got == tuple(want))
        n += 1
    assert n == len(FLAGS) * 4 * 2


def test_partition_spec_is_a_tuple_of_its_entries():
    p = tplan.P(None, ("data", "model"), "model")
    assert p == (None, ("data", "model"), "model") == tuple(
        JaxP(None, ("data", "model"), "model"))
    assert isinstance(p, tuple) and repr(p).startswith("P(")
    import pickle
    assert pickle.loads(pickle.dumps(p)) == p
