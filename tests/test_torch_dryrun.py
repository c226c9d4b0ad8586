"""The port's dry run (``launch/dryrun.py``) against the reference's
sharding specs.

  * Per-device argument bytes: for every one of the 10 assigned archs x
    4 ``SHAPES`` on the (16, 16) and (2, 16, 16) production meshes, the
    port's spec arithmetic (``argument_bytes``, each argument leaf's
    block under its spec) equals, exactly, the sum of
    ``NamedSharding.shard_shape`` bytes that the reference's own
    ``state_specs`` / ``params_specs`` / ``batch_specs`` /
    ``cache_specs_trees`` give on a ``jax.sharding.AbstractMesh`` (no
    compile): the train state (float32 params, m, v and the int32 step)
    and batch, or the served weights in the compute type, the batch and
    the caches.
  * One full-size cell runs whole: ``mistral-nemo-12b`` x
    ``decode_32k`` on the (16, 16) mesh completes on the meta device as
    rank 0 of a 256-process fake group and writes its record, with
    every key, through ``write_json_atomic``; its argument bytes are
    the local blocks it built, equal to the spec arithmetic (1.532 GB
    of served weights and 2.684 GB of caches a device).
"""

import json
import math

import jax
import pytest

from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as j_config
from repro.launch import steps as JS
from repro.models import get_model_def as j_model_def

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import get_model_def

MESHES = {"pod": (("data", "model"), (16, 16)),
          "multipod": (("pod", "data", "model"), (2, 16, 16))}


def _shard_bytes(sds, shardings):
    leaves = jax.tree.leaves(shardings,
                             is_leaf=lambda x: isinstance(x, NamedSharding))
    return sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
               for x, s in zip(jax.tree.leaves(sds), leaves))


def reference_argument_bytes(arch, shape, names, sizes):
    """The reference's per-device argument bytes of a dry-run cell, from
    its own spec functions on an ``AbstractMesh`` (its
    ``effective_config``: camformer for long_500k on the attention
    families)."""
    cfg = j_config(arch)
    if shape == "long_500k" and cfg.family in D.ATTENTION_FAMILIES:
        cfg = cfg.replace(attn_backend="camformer")
    md = j_model_def(cfg)
    mesh = AbstractMesh(sizes, names)
    sh = SHAPES[shape]
    if sh["kind"] == "train":
        total = _shard_bytes(*JS.state_specs(md, cfg, mesh))
        return total + _shard_bytes(*JS.batch_specs(cfg, shape, mesh))
    total = _shard_bytes(*JS.params_specs(md, cfg, mesh, serve=True))
    total += _shard_bytes(*JS.batch_specs(cfg, shape, mesh,
                                          serve=sh["kind"] == "decode"))
    return total + _shard_bytes(*JS.cache_specs_trees(
        md, cfg, sh["global_batch"], sh["seq_len"], mesh))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_argument_bytes_equal_the_reference_shard_shapes(arch, shape, mesh):
    names, sizes = MESHES[mesh]
    cfg, _ = D.effective_config(arch, shape, None)
    got = D.argument_bytes(get_model_def(cfg), cfg, shape,
                           MeshShape(names, sizes))
    assert got == reference_argument_bytes(arch, shape, names, sizes)


def test_a_full_size_cell_runs_and_writes_its_record(tmp_path):
    import torch.distributed as dist

    try:
        rec = D.run_cell("mistral-nemo-12b", "decode_32k", multi_pod=False,
                         out_dir=str(tmp_path))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    path = tmp_path / "mistral-nemo-12b_decode_32k_pod.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    assert set(rec) == {"arch", "shape", "kind", "mesh", "chips",
                        "backend", "note", "tag", "profile", "n_params",
                        "trace_s", "memory", "counted", "roofline"}
    assert set(rec["memory"]) == {"argument_bytes", "peak_bytes"}
    assert set(rec["counted"]) == {
        "flops_per_device", "dot_bytes_per_device",
        "collective_bytes_per_device", "collectives"}
    assert rec["chips"] == 256 and rec["kind"] == "decode"
    cfg, _ = D.effective_config("mistral-nemo-12b", "decode_32k", None)
    want = reference_argument_bytes("mistral-nemo-12b", "decode_32k",
                                    *MESHES["pod"])
    assert rec["memory"]["argument_bytes"] == want == D.argument_bytes(
        get_model_def(cfg), cfg, "decode_32k", MeshShape(*MESHES["pod"]))
    assert rec["memory"]["peak_bytes"] >= want
    assert rec["counted"]["flops_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
