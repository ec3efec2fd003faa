"""The port's partition specs (``repro_torch.launch.mesh``) and abstract
cell state (``launch.steps.input_specs`` / ``abstract_state``) against the
reference's ``repro.launch.mesh`` and ``repro.launch.steps``.

Both packages' plans are built over a stand-in mesh that carries only the
axis names and sizes (the spec rules read nothing else), so no device
mesh is made here.  The reference's layer leaves are stacked on a leading
layer axis; the port's are one tensor a layer (``weights.lm_flat``'s
names): a port layer leaf's spec must equal the reference's stacked spec
without its leading entry, and its shape the stacked shape without L.
Specs are compared as tuples (``tuple(PartitionSpec)``), exactly.
"""
import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as ref_config
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.nn import transformer as jtfm
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs
from repro_torch.launch import context, mesh
from repro_torch.launch import steps
from repro_torch.nn.transformer import layer_groups
from repro_torch.optim import OptConfig

PLANS = {"single": ((16, 16), ("data", "model")),
         "multi": ((2, 16, 16), ("pod", "data", "model"))}


class _PortMesh:
    def __init__(self, shape, axes):
        self.shape, self.mesh_dim_names = shape, axes
        self.ndim = len(shape)

    def size(self, i):
        return self.shape[i]


class _RefMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _plans(kind):
    shape, axes = PLANS[kind]
    return mesh.Plan(_PortMesh(shape, axes)), jmesh.Plan(_RefMesh(shape,
                                                                   axes))


def _ref_flat(tree, is_leaf=None):
    """{dotted path: leaf} of a reference pytree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


def _port_key_pairs(cfg, ref_keys):
    """(reference key, port key, stacked) for every reference leaf:
    ``group{g}.name`` -> ``layers.{j}.name`` for each layer j of group g."""
    firsts, first = [], 0
    for g in layer_groups(cfg):
        firsts.append((first, g.count))
        first += g.count
    for rk in ref_keys:
        head, _, rest = rk.partition(".")
        if head.startswith("group"):
            f, n = firsts[int(head[5:])]
            for j in range(f, f + n):
                yield rk, f"layers.{j}.{rest}", True
        else:
            yield rk, rk, False


def _is_spec(x):
    return isinstance(x, P)


def _check_specs(cfg, ref_tree, port_flat):
    ref = _ref_flat(ref_tree, is_leaf=_is_spec)
    seen = set()
    for rk, pk, stacked in _port_key_pairs(cfg, ref):
        want = tuple(ref[rk])[1:] if stacked else tuple(ref[rk])
        assert port_flat[pk] == want, (cfg.name, pk, port_flat[pk], want)
        seen.add(pk)
    assert seen == set(port_flat), (cfg.name, set(port_flat) ^ seen)


def _flat_port(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("kind", sorted(PLANS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch, kind):
    plan, jplan = _plans(kind)
    cfg, jcfg = configs.get_config(arch), ref_config(arch)
    jparams = jtfm.abstract_params(jcfg)
    params = steps.abstract_state(cfg, "prefill_32k")[0]
    jps = jmesh.param_specs(jparams, jplan)
    ps = mesh.param_specs(params, plan)
    _check_specs(cfg, jps, ps)
    # ZeRO-1 with int8 moments: payload like the parameter, scales without
    # its last axis
    jopt = jax.eval_shape(
        lambda p: jadamw_init(p, JOptConfig(state_dtype="int8")), jparams)
    opt = steps.abstract_state(cfg, "train_4k",
                               OptConfig(state_dtype="int8"))[1]
    jos, os_ = jmesh.opt_specs(jopt, jps), mesh.opt_specs(opt, ps)
    assert os_["step"] == tuple(jos["step"]) == ()
    for mom in ("m", "v"):
        _check_specs(cfg, {k: v for k, v in jos[mom].items()},
                     _flat_port(os_[mom]))
    for shape in SHAPES:
        if not cfg.shape_supported(shape)[0]:
            continue
        got = mesh.batch_specs(steps.input_specs(cfg, shape), plan)
        want = jmesh.batch_specs(jsteps.input_specs(jcfg, shape), jplan)
        assert got == {k: tuple(v) for k, v in want.items()}, (arch, shape)
        if SHAPES[shape]["kind"] == "decode":
            cache = steps.abstract_state(cfg, shape)[1]
            jcache = jsteps.abstract_state(jcfg, shape)[1]
            cs = mesh.cache_specs(cache, plan)
            port = {f"layers.{j}.{k}": v for j, layer in enumerate(cs)
                    for k, v in _flat_port(layer).items()}
            _check_specs(cfg, jmesh.cache_specs(jcache, jplan), port)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_state_matches_reference_shapes(arch):
    cfg, jcfg = configs.get_config(arch), ref_config(arch)
    for shape in SHAPES:
        assert cfg.shape_supported(shape) == jcfg.shape_supported(shape)
        if not cfg.shape_supported(shape)[0]:
            continue
        batch, jbatch = steps.input_specs(cfg, shape), \
            jsteps.input_specs(jcfg, shape)
        assert set(batch) == set(jbatch)
        for k, v in batch.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(jbatch[k].shape), (arch, shape, k)
            assert _dtype_name(v) == str(jbatch[k].dtype), (arch, shape, k)
        params, aux = steps.abstract_state(cfg, shape)
        jparams, jaux = jsteps.abstract_state(jcfg, shape)
        named = dict(params.named_parameters())
        ref = _ref_flat(jparams)
        for rk, pk, stacked in _port_key_pairs(cfg, ref):
            want = tuple(ref[rk].shape)[1:] if stacked \
                else tuple(ref[rk].shape)
            assert tuple(named[pk].shape) == want, (arch, pk)
            assert named[pk].device.type == "meta"
        kind = SHAPES[shape]["kind"]
        if kind == "train":
            jm = _ref_flat(jaux["m"])
            for rk, pk, stacked in _port_key_pairs(cfg, jm):
                want = tuple(jm[rk].shape)[1:] if stacked \
                    else tuple(jm[rk].shape)
                assert tuple(aux["m"][pk].shape) == want, (arch, pk)
        elif kind == "decode":
            jc = _ref_flat(jaux)
            port = {f"layers.{j}.{k}": v for j, layer in enumerate(aux)
                    for k, v in _flat_port(layer).items()}
            for rk, pk, stacked in _port_key_pairs(cfg, jc):
                assert tuple(port[pk].shape) == tuple(jc[rk].shape)[1:]
                assert _dtype_name(port[pk]) == str(jc[rk].dtype)
        else:
            assert aux is None and jaux is None


def test_plan_batch_axes_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    plan = _plans("multi")[0]
    assert plan.batch_spec_axes(64) == ("pod", "data")
    assert plan.batch_spec_axes(16) == "data"
    assert plan.batch_spec_axes(3) is None
    assert plan.placements((("pod", "data"), None, "model")) \
        == (Shard(0), Shard(0), Shard(2))
    assert plan.placements(()) == (Replicate(),) * 3
    # no plan: the hint is the identity
    x = object()
    assert context.shard_hint(x, "batch") is x
    with context.use_plan(plan):
        assert context.current_plan() is plan
    assert context.current_plan() is None
