"""The port's logical-axis partitioning against the JAX package's, in this
process (no spawn): for all 11 configs, on the meshes (1, 1), (2, 2),
(4, 2), (16, 16) and (2, 16, 16), under both parallelism profiles, the
specs of the parameters (training and serving rules), the optimizer
state, the train and decode batches and the contiguous caches equal the
reference's entry for entry (the reference resolves on a device-free
``AbstractMesh``, the port on a ``MeshShape``); the DTensor placements
of each spec give every rank the block the reference's spec assigns it
(rank by rank under torch's fake process group, which runs no
collective); the production meshes' shapes; and a mesh that does not
match the world raises."""

import jax
import numpy as np
import pytest
import torch.distributed as dist

from repro.configs import get_config as j_config
from repro.configs import smoke_config as j_smoke
from repro.configs.base import list_archs
from repro.launch.inputs import input_specs as j_input_specs
from repro.launch.inputs import serve_input_specs as j_serve_specs
from repro.models import get_model_def as j_model_def
from repro.models.module import param_shapes as j_param_shapes
from repro.models.module import tree_axes
from repro.sharding import partitioning as JP

from repro_torch.configs import get_config as t_config
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.steps import (batch_specs, cache_specs_trees,
                                      params_specs, state_specs)
from repro_torch.models import get_model_def as t_model_def
from repro_torch.sharding import partitioning as TP
from repro_torch.train.checkpoint import local_block

ARCHS = list_archs()
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHES = [(128, 32768), (1, 524288)]  # decode_32k and long_500k


@pytest.fixture
def profiles():
    """Both packages' profile back to ``tp`` after the test: the rules
    are module globals shared by every test of this process."""
    try:
        yield
    finally:
        JP.set_parallelism_profile("tp")
        TP.set_parallelism_profile("tp")


def _same(port, ref, where):
    """Port spec tree == reference spec tree, where the port keeps a list
    of layers the reference stacks (its specs lead with the layers
    axis's None)."""
    if isinstance(port, list):
        for i, layer in enumerate(port):
            if isinstance(ref, (list, tuple)) and not _is_spec(ref):
                _same(layer, ref[i], f"{where}/{i}")
            else:  # stacked on the reference's side
                _same(layer, jax.tree.map(
                    lambda s: tuple(s)[1:], ref, is_leaf=_is_spec),
                    f"{where}/{i}")
        return
    if isinstance(port, dict):
        assert set(port) == set(ref), (where, set(port), set(ref))
        for k in port:
            _same(port[k], ref[k], f"{where}/{k}")
        return
    assert tuple(port) == tuple(ref), (where, port, ref)


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec) or (
        isinstance(x, tuple) and all(
            e is None or isinstance(e, (str, tuple)) for e in x))


def _cache_specs(md, cfg, b, length, mesh):
    tree = md.cache_specs(cfg, b, length)
    leaf = lambda x: (isinstance(x, tuple) and len(x) == 2
                      and isinstance(x[0], jax.ShapeDtypeStruct))
    return jax.tree.map(lambda t: JP.resolve_spec(t[1], t[0].shape, mesh,
                                                  JP.CACHE_RULES),
                        tree, is_leaf=leaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, profiles):
    jc, tc = j_config(arch), t_config(arch)
    jmd, tmd = j_model_def(jc), t_model_def(tc)
    specs = jmd.specs(jc)
    for profile in ("tp", "dp"):
        JP.set_parallelism_profile(profile)
        TP.set_parallelism_profile(profile)
        for shape, names in MESHES:
            jm = jax.sharding.AbstractMesh(shape, names)
            tm = t_mesh.MeshShape(names, shape)
            at = f"{arch} {profile} {shape}"
            for serve, rules in ((False, JP.PARAM_RULES),
                                 (True, JP.SERVE_PARAM_RULES)):
                want = JP.tree_pspecs(tree_axes(specs),
                                      j_param_shapes(specs), jm, rules)
                _same(params_specs(tmd, tc, tm, serve=serve)[1], want,
                      f"{at} params serve={serve}")
            state = state_specs(tmd, tc, tm)[1]
            _same(state["opt"]["m"], JP.tree_pspecs(
                tree_axes(specs), j_param_shapes(specs), jm,
                JP.PARAM_RULES), f"{at} m")
            assert state["opt"]["v"] == state["opt"]["m"] == state["params"]
            assert state["opt"]["step"] == ()
            for name, serve in (("train_4k", False), ("decode_32k", True)):
                sds, axes = (j_serve_specs if serve else j_input_specs)(
                    jc, name)
                want = {k: JP.resolve_spec(axes[k], sds[k].shape, jm,
                                           JP.ACT_RULES) for k in sds}
                _same(batch_specs(tc, name, tm, serve=serve)[1], want,
                      f"{at} batch {name}")
            for b, length in CACHES:
                _same(cache_specs_trees(tmd, tc, b, length, tm)[1],
                      _cache_specs(jmd, jc, b, length, jm),
                      f"{at} cache {b}x{length}")


def _ref_block(full, spec, coords, sizes):
    """The reference spec's block of ``full``: each dimension split
    major-to-minor over its entry's mesh axes."""
    idx = []
    for dim, entry in zip(full.shape, tuple(spec)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n, k = 1, 0
        for a in axes:
            k, n = k * sizes[a] + coords[a], n * sizes[a]
        idx.append(slice(k * dim // n, (k + 1) * dim // n))
    return full[tuple(idx)]


def _port_leaf(node, parts):
    """The port's spec at a reference key: a list of per-layer specs
    where the port keeps a list of layers."""
    for i, part in enumerate(parts):
        if isinstance(node, list):
            return [_port_leaf(layer, parts[i:]) for layer in node]
        node = node[part]
    return node


def _fake_group(rank, world):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


@pytest.mark.parametrize("arch", ["camformer-bert", "granite-moe-3b-a800m",
                                  "recurrentgemma-2b"])
def test_placements_give_each_rank_the_reference_block(arch, profiles):
    from torch.distributed.device_mesh import init_device_mesh

    jc, tc = j_smoke(arch), t_smoke(arch)
    specs = j_model_def(jc).specs(jc)
    flat = [(jax.tree_util.keystr(p), s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: hasattr(x, "axes"))]
    checked = 0
    for profile in ("tp", "dp"):
        JP.set_parallelism_profile(profile)
        TP.set_parallelism_profile(profile)
        for shape in ((2, 2), (4, 2)):
            names = ("data", "model")
            sizes = dict(zip(names, shape))
            want = dict(zip([k for k, _ in flat], jax.tree.leaves(
                JP.tree_pspecs(tree_axes(specs), j_param_shapes(specs),
                               jax.sharding.AbstractMesh(shape, names),
                               JP.PARAM_RULES),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
            world = int(np.prod(shape))
            for rank in range(world):
                _fake_group(rank, world)
                try:
                    mesh = init_device_mesh("cpu", shape,
                                            mesh_dim_names=names)
                    coords = dict(zip(names, mesh.get_coordinate()))
                    port = params_specs(t_model_def(tc), tc, mesh)[1]
                    for key, p in flat:
                        node = _port_leaf(port,
                                          key.strip("[]'").split("']['"))
                        full = np.arange(int(np.prod(p.shape))).reshape(
                            p.shape)
                        layers = node if isinstance(node, list) else [node]
                        for i, spec in enumerate(layers):
                            one = full[i] if isinstance(node, list) else full
                            ref = (tuple(want[key])[1:]
                                   if isinstance(node, list)
                                   else tuple(want[key]))
                            got = local_block(one, mesh,
                                              TP.placements(spec, mesh))
                            np.testing.assert_array_equal(
                                got, _ref_block(one, ref, coords, sizes),
                                err_msg=f"{arch} {profile} {shape} "
                                        f"rank {rank} {key}")
                            checked += 1
                finally:
                    dist.destroy_process_group()
    assert checked > 0


def test_production_mesh_shapes():
    m1 = t_mesh.make_production_mesh()
    assert dict(m1.shape) == {"data": 16, "model": 16}
    m2 = t_mesh.make_production_mesh(multi_pod=True)
    assert dict(m2.shape) == {"pod": 2, "data": 16, "model": 16}
    assert m2.size == 512


def test_mesh_that_does_not_match_the_world_raises():
    with pytest.raises(ValueError, match="make_mesh_for"):
        t_mesh.make_mesh_for(4, 2)  # no process group
    _fake_group(0, 4)
    try:
        with pytest.raises(ValueError, match="make_mesh_for"):
            t_mesh.make_mesh_for(8, 2)
        with pytest.raises(ValueError, match="multiple"):
            t_mesh.make_mesh_for(4, 3)
        mesh = t_mesh.make_mesh_for(4, 2)
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {
            "data": 2, "model": 2}
        # a spec entry out of the mesh's axis order has no placements
        with pytest.raises(ValueError, match="order"):
            TP.placements((("model", "data"),), mesh)
    finally:
        dist.destroy_process_group()
