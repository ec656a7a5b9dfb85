"""The port's sharding rules (``repro_torch.sharding.specs``) against the
reference's (``repro.sharding.specs``), on the CPU.

The reference's rules read only ``mesh.shape[name]``, so both sides take a
mesh described by its axis sizes (no 256 devices needed). Specs: every
parameter leaf of every full-width config, on both production meshes,
under the "tp" and "dp" profiles, FSDP on and off; the port keeps repeated
units as lists, so its leaf's spec is the reference's without the stacked
unit's leading None. Decode-state specs of every decoding arch at
decode_32k and long_500k; ``batch_spec``, ``dp_axes`` and
``activation_rules`` over a table of cases. On a fake (2, 16, 16) world
(started and destroyed around its tests), each leaf's local shape under
its placements; ``shard_batch`` on a one-rank gloo group.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable as j_shape_applicable
from repro.configs.base import long_context_variant as j_long_context_variant
from repro.models import lm as jlm
from repro.sharding import specs as jspecs
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs, long_context_variant
from repro_torch.data.pipeline import TokenPipeline, shard_batch
from repro_torch.device import MetaGenerator
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.sharding import specs as tspecs
from repro_torch.utils.tree import tree_map_with_path

ARCHS = list_archs()
MESHES = {"pod1": {"data": 16, "model": 16}, "pod2": {"pod": 2, "data": 16, "model": 16}}
PROFILES = [("tp", False), ("tp", True), ("dp", False)]


def _mesh(name):
    return SimpleNamespace(shape=dict(MESHES[name]))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, long=False):
    cfg = jget_config(arch)
    if long:
        cfg = j_long_context_variant(cfg)
    return cfg, jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _port_params(arch, long=False):
    cfg = get_config(arch)
    if long:
        cfg = long_context_variant(cfg)
    return cfg, tlm.init_lm(MetaGenerator(), cfg, "meta")


def _ref_flat(tree, is_leaf=None):
    """{path of keys: leaf} of a reference tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in flat}


def _port_flat(tree):
    out = {}
    tree_map_with_path(lambda path, leaf: out.__setitem__(tuple(map(str, path)), leaf), tree)
    return out


def _port_specs_flat(spec_tree, tree):
    """{path: spec} of a port spec tree, walked along its tensor tree."""
    out = {}

    def visit(path, _leaf):
        node = spec_tree
        for p in path:
            node = node[p]
        out[tuple(map(str, path))] = node

    tree_map_with_path(visit, tree)
    return out


STACKED = ("units", "enc_units", "cross")


def _match(ref: dict, port: dict, n_units: dict) -> int:
    """Every reference leaf's spec against the port's: a stacked leaf
    (``units``, ``enc_units``, the cross K/V) against each unit's leaf,
    with the unit's leading None dropped. Returns the leaves compared."""
    n = 0
    for path, spec in ref.items():
        spec = tuple(spec)
        if path[0] in STACKED:
            assert not spec or spec[0] is None, (path, spec)   # P() replicates all
            for u in range(n_units[path[0]]):
                got = port[(path[0], str(u), *path[1:])]
                assert got == spec[1:], (path, u, got, spec)
                n += 1
        else:
            assert port[path] == spec, (path, port[path], spec)
            n += 1
    assert n == len(port), (n, len(port))
    return n


def _units(cfg):
    return {"units": cfg.n_units, "enc_units": cfg.n_encoder_layers, "cross": cfg.n_units}


@pytest.mark.parametrize("profile,fsdp", PROFILES, ids=lambda v: str(v))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh_name, profile, fsdp):
    jcfg, jparams = _ref_params(arch)
    cfg, params = _port_params(arch)
    mesh = _mesh(mesh_name)
    ref = _ref_flat(jspecs.param_spec_tree(jparams, mesh, fsdp=fsdp, profile=profile),
                    is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    port = _port_specs_flat(tspecs.param_spec_tree(params, mesh, fsdp=fsdp, profile=profile),
                            params)
    assert _match(ref, port, _units(cfg)) == len(_port_flat(params))
    if profile == "tp":
        # the rules shard something of every model on the production mesh
        assert any(s and any(a is not None for a in s) for s in port.values())


def _decode_cases():
    for arch in ARCHS:
        for shape in ("decode_32k", "long_500k"):
            ok, _ = j_shape_applicable(jget_config(arch), J_SHAPES[shape])
            if ok:
                for mesh_name in sorted(MESHES):
                    yield arch, shape, mesh_name


@pytest.mark.parametrize("arch,shape,mesh_name", list(_decode_cases()))
def test_decode_state_specs_match_reference(arch, shape, mesh_name):
    long = shape == "long_500k"
    jcfg, jparams = _ref_params(arch, long)
    cfg, params = _port_params(arch, long)
    B, S = INPUT_SHAPES[shape].global_batch, INPUT_SHAPES[shape].seq_len
    mesh = _mesh(mesh_name)
    enc = (B, cfg.encoder_seq_len, cfg.d_model)
    jstate = jax.eval_shape(
        lambda p: jlm.init_decode_state(
            p, jcfg, B, S, enc_out=jnp.zeros(enc, jcfg.jnp_dtype) if jcfg.n_encoder_layers
            else None), jparams)
    state = tlm.init_decode_state(
        params, cfg, B, S, enc_out=torch.zeros(enc, dtype=cfg.torch_dtype, device="meta")
        if cfg.n_encoder_layers else None)
    ref = _ref_flat(jax.tree_util.tree_map_with_path(
        lambda path, leaf: jspecs.decode_state_spec(path, leaf, mesh, B), jstate),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    port = _port_specs_flat(tree_map_with_path(
        lambda path, leaf: tspecs.decode_state_spec(path, leaf, mesh, B), state), state)
    assert _match(ref, port, _units(cfg)) == len(_port_flat(state))
    # the caches are sharded: over the batch at decode_32k, over the
    # sequence at batch 1
    for spec in (s for p, s in port.items() if p[-1] in ("k", "v")):
        assert spec[1] == "data" if long else spec[0] is not None, spec


SIZES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
         {"data": 1, "model": 1}, {"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 4}]


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("batch", [256, 128, 32, 48, 8, 1])
@pytest.mark.parametrize("profile", ["tp", "dp"])
@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: "x".join(map(str, s.values())))
def test_batch_spec_matches_reference(sizes, profile, batch, ndim):
    mesh = SimpleNamespace(shape=dict(sizes))
    want = tuple(jspecs.batch_spec(mesh, batch, ndim, profile))
    assert tspecs.batch_spec(mesh, batch, ndim, profile) == want


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("profile", ["tp", "dp"])
@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: "x".join(map(str, s.values())))
def test_dp_axes_and_activation_rules_match_reference(sizes, profile, train):
    mesh = SimpleNamespace(shape=dict(sizes))
    assert tspecs.dp_axes(mesh, profile) == jspecs.dp_axes(mesh, profile)
    assert (tspecs.activation_rules(mesh, train=train, profile=profile)
            == jspecs.activation_rules(mesh, train=train, profile=profile))


def test_leaf_name_reads_list_indices_and_moe():
    assert tspecs._leaf_name(("units", 3, "b0", "ffn", "moe", "w_in")) == ("w_in", True)
    assert tspecs._leaf_name(("units", 0, "b0", "ffn", "mlp", "w_in")) == ("w_in", False)
    assert tspecs._leaf_name(()) == ("", False)


def test_placements_order_and_rejects_minor_first():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tspecs.placements((("pod", "data"), "model"), mesh) == [Shard(0), Shard(0), Shard(1)]
    assert tspecs.placements((None, None), mesh) == [Replicate()] * 3
    assert tspecs.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        tspecs.placements((("data", "pod"), None), mesh)


@pytest.fixture
def one_rank_gloo(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_shard_batch_one_rank_gives_the_batch_back(one_rank_gloo):
    from torch.distributed.tensor import DTensor

    mesh = tmesh.make_host_mesh(1, device="cpu")
    assert tmesh.axis_sizes(mesh) == {"data": 1, "model": 1}
    raw = TokenPipeline(1000, 16, 4, seed=3).batch(2)
    out = shard_batch(raw, mesh, tspecs.batch_spec(mesh, 4, 2))
    assert isinstance(out["tokens"], DTensor)
    assert torch.equal(out["tokens"].full_tensor(), torch.from_numpy(raw["tokens"]))


class TestProductionMesh:
    """Local shapes on a fake (2, 16, 16) world: started for this class
    only, so no process group leaks into other tests of the worker."""

    @pytest.fixture(scope="class")
    def pod2(self):
        tmesh.start_fake_world(tmesh.production_chip_count(multi_pod=True))
        try:
            yield tmesh.make_production_mesh(multi_pod=True)
        finally:
            tmesh.stop_world()

    def test_mesh_shape_and_labels(self, pod2):
        assert tmesh.production_mesh_shape() == (16, 16)
        assert tmesh.production_mesh_shape(multi_pod=True) == (2, 16, 16)
        assert tmesh.production_chip_count() == 256
        assert tuple(pod2.mesh_dim_names) == ("pod", "data", "model")
        assert tmesh.axis_sizes(pod2) == {"pod": 2, "data": 16, "model": 16}
        assert tmesh.mesh_chips(pod2) == 512 and tmesh.mesh_label(pod2) == "2x16x16"
        with pytest.raises(RuntimeError):
            tmesh.make_production_mesh(multi_pod=False)    # a 512-rank world

    def test_a_leaf_under_replicate_shard_shard(self, pod2):
        spec = ("data", "model")
        assert tspecs.local_shape((4096, 8192), spec, pod2) == (256, 512)
        assert tspecs.local_shape((4096, 8192), (("pod", "data"), "model"), pod2) == (128, 512)

    def test_pod_major_like_the_reference(self, pod2):
        """A dim over ("pod", "data") is split pod-major: the rank at pod 1,
        data 0 holds the second half's first shard."""
        from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

        where = tspecs.placements((("pod", "data"), None), pod2)
        for coord, start in (([1, 0, 0], 2048), ([0, 1, 0], 128), ([1, 3, 5], 2048 + 3 * 128)):
            shape, off = _compute_local_shape_and_global_offset((4096, 64), (2, 16, 16), coord,
                                                                where)
            assert shape == (128, 64) and off == (start, 0), (coord, off)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_param_local_shapes(self, pod2, arch):
        cfg, params = _port_params(arch)
        sizes = tmesh.axis_sizes(pod2)
        specs = _port_specs_flat(tspecs.param_spec_tree(params, pod2, fsdp=True), params)
        sharding = _port_specs_flat(tspecs.param_sharding_tree(params, pod2, fsdp=True), params)

        def check(path, leaf):
            spec = specs[tuple(map(str, path))]
            want = []
            for dim, entry in zip(leaf.shape, spec):
                n = 1
                for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                    n *= sizes[a]
                assert dim % n == 0
                want.append(dim // n)
            assert tspecs.local_shape(leaf.shape, spec, pod2) == tuple(want), path
            m, where = sharding[tuple(map(str, path))]
            assert m is pod2 and where == tspecs.placements(spec, pod2)

        tree_map_with_path(check, params)
