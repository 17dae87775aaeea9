"""The port's partition rules (``launch.sharding``) against the JAX
package's, spec for spec: every full arch's params, the pod-stacked specs,
the batch specs at the four input shapes and the decode caches (both
``cross_mode``s), on the (16, 16) and (2, 16, 16) production meshes, (1,
1), (2, 2, 2) and a mesh whose sizes divide nothing. The JAX rules read
only ``mesh.axis_names`` and ``mesh.devices.shape``, so a stand-in with
those two attributes takes the place of 512 devices; the param and cache
shapes are the port's meta-built trees, fed to both packages. Also
``placements``: a spec as DTensor placements."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import sharding as jsh
from repro_torch import configs
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import sharding as sh
from repro_torch.models import build

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "3x5x7": ((3, 5, 7), ("pod", "data", "model")),
}
MODES = [dict(), dict(embed_mode="replicated_vocab", param_mode="tp_only",
                      moe_mode="ep_only"), dict(embed_mode="vocab_model")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(name):
    shape, names = MESHES[name]
    return (types.SimpleNamespace(axis_names=names, devices=np.empty(shape)),
            sh.MeshShape(names, shape))


def _sds(tree):
    """The port's meta tree as JAX shape stand-ins, path for path."""
    if isinstance(tree, dict):
        return {k: _sds(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _flat(specs, prefix=""):
    if isinstance(specs, dict):
        return {p: s for k, v in specs.items()
                for p, s in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tuple(specs)}


@pytest.fixture(scope="module")
def trees():
    """Per arch: the meta params and the decode cache of each decode
    shape."""
    out = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        fns = build(cfg)
        caches = {}
        for name, shape in configs.INPUT_SHAPES.items():
            if shape.kind != "decode":
                continue
            kw = {"windowed": cfg.has_attention and name == "long_500k"}
            if cfg.is_encoder_decoder:
                kw["enc_len"] = min(shape.seq_len // 2, 4096)
            caches[name] = fns.init_decode_cache(
                shape.global_batch, shape.seq_len, device="meta", **kw)
        out[arch] = (fns.init(torch.Generator(), device="meta"), caches)
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_and_pod_specs_match_reference(mesh_name, trees):
    jmesh, tmesh = _meshes(mesh_name)
    n = 0
    for arch, (params, _) in trees.items():
        for mode in MODES:
            ref = jsh.param_pspecs(_sds(params), jmesh, **mode)
            out = sh.param_pspecs(params, tmesh, **mode)
            assert _flat(out) == _flat(ref), (arch, mode)
            assert _flat(sh.stack_pspecs_for_pods(out, tmesh)) == _flat(
                jsh.stack_pspecs_for_pods(ref, jmesh)), (arch, mode)
            n += len(_flat(out))
    assert n > 400


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_specs_match_reference(mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    assert sh.dp_spec_axes(tmesh) == jsh.dp_spec_axes(jmesh)
    for arch in configs.ARCH_IDS:
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
        for name, shape in configs.INPUT_SHAPES.items():
            jshape = jconfigs.INPUT_SHAPES[name]
            for stacked in (True, False):
                out = sh.batch_pspecs(cfg, shape, tmesh, pod_stacked=stacked)
                ref = jsh.batch_pspecs(jcfg, jshape, jmesh,
                                       pod_stacked=stacked)
                assert {k: tuple(v) for k, v in ref.items()} == out
            n_pods = dict(zip(*MESHES[mesh_name][::-1])).get("pod", 1)
            if shape.global_batch % n_pods == 0:
                sds = sh.stacked_batch_sds(cfg, shape, tmesh)
                jsds = jsh.stacked_batch_sds(jcfg, jshape, jmesh)
                assert {k: tuple(v.shape) for k, v in sds.items()} == \
                    {k: tuple(v.shape) for k, v in jsds.items()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_decode_cache_specs_match_reference(mesh_name, trees):
    jmesh, tmesh = _meshes(mesh_name)
    for arch, (_, caches) in trees.items():
        cfg = configs.get_config(arch)
        for name, cache in caches.items():
            b = configs.INPUT_SHAPES[name].global_batch
            for cross in ("head_sharded", "seq_sharded"):
                out = sh.decode_cache_pspecs(cfg, cache, tmesh, batch=b,
                                             cross_mode=cross)
                ref = jsh.decode_cache_pspecs(
                    jconfigs.get_config(arch), _sds(cache), jmesh, batch=b,
                    cross_mode=cross)
                assert _flat(out) == _flat(ref), (arch, name, cross)


def test_group_specs_and_dp_axes():
    tree = {"w": torch.zeros(4, 3), "b": {"c": torch.zeros(4)}}
    ref = jsh.group_pspecs({"w": 0, "b": {"c": 0}})
    assert _flat(sh.group_pspecs(tree)) == _flat(ref)
    for name in MESHES:
        assert lmesh.dp_axes(_meshes(name)[1]) == \
            jsh.dp_spec_axes(_meshes(name)[0])


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = sh.MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert sh.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert sh.placements((), mesh) == (Replicate(),) * 3
    # an axis the mesh lacks is dropped (a pod spec on the pod's submesh)
    sub = sh.MeshShape(("data", "model"), (2, 2))
    assert sh.placements(("pod", "data", "model"), sub) == (Shard(1),
                                                           Shard(2))
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements((("data", "pod"),), mesh)


def test_production_mesh_needs_the_fake_world():
    """Without the fake backend's 256 or 512 ranks the production mesh
    cannot exist on one card, and the error says so."""
    with pytest.raises(RuntimeError, match="fake process group"):
        lmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        lmesh.make_production_mesh(multi_pod=True)
