"""The port's sharding rules (``repro_torch.dist.sharding``) against the
reference's (``repro.dist.sharding``), element for element, and the
port's placement helpers, on the CPU with no devices.

The reference's rules run on ``jax.sharding.AbstractMesh``, the port's on
its ``MeshShape`` (or a plain ``{axis: size}`` dict) of the same sizes.
Each package builds its own trees: the parameters from its
``abstract_params`` (meta tensors in the port, ``jax.eval_shape`` in the
reference) for all ten registry ids at full width, the decode caches from
its ``init_cache`` (under ``FakeTensorMode`` in the port, ``eval_shape`` in
the reference). Contracts:
- ``param_specs`` (plain, and with ``fed_axis="pod"`` on the pod mesh),
  ``opt_specs``, ``cache_specs``, ``batch_specs`` and ``serve_arg_specs``
  equal the reference's on every leaf, on the meshes (data, model) of (1,
  2), (4, 2), (16, 16) and (pod, data, model) of (2, 16, 16);
- ``spec_for_leaf`` on the reference's edge cases (``tests/test_sharding_edges.py``:
  1-D leaves, GQA K/V narrower than the model axis, odd vocabs, expert
  stacks either side of divisibility) equals the reference's;
- ``slot_rows`` is every rank's block of the slot dim under
  ``serve_arg_specs`` and of a k/v cache leaf's batch dim under
  ``cache_specs``, and every slot where ``data`` does not divide them;
- ``shard_tree`` then ``gather_tree`` is the identity, on tensors and on
  numpy trees;
- ``make_production_mesh`` and ``make_host_mesh`` have the reference's
  shapes and clamps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as j_configs
from repro.dist import sharding as JS
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.dist import sharding as S
from repro_torch.launch.mesh import HW, make_host_mesh, make_production_mesh
from repro_torch.models import transformer as T
from _torch_threads import torch_threads  # noqa: F401

MESHES = {"1x2": ((1, 2), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _abstract_mesh(shape, names):
    try:
        return jax.sharding.AbstractMesh(shape, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, shape)))


def _meshes(key):
    shape, names = MESHES[key]
    return S.MeshShape(names, shape), _abstract_mesh(shape, names)


def _flat(tree, is_spec=False):
    """{path: leaf} of a nested dict (a spec tuple, or a PartitionSpec as a
    tuple, is one leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            for path, leaf in _flat(v, is_spec).items():
                out[(k, *path)] = leaf
        return out
    return {(): tuple(tree) if is_spec else tree}


def _assert_same_specs(got, want):
    got, want = _flat(got, True), _flat(want, True)
    assert got.keys() == want.keys()
    for path in want:
        assert got[path] == want[path], (path, got[path], want[path])


@functools.lru_cache(maxsize=None)
def _params(arch_id):
    """(the port's meta tree, the reference's eval_shape tree) at full width."""
    return (T.abstract_params(configs.get_arch(arch_id)),
            JT.abstract_params(j_configs.get_arch(arch_id)))


@functools.lru_cache(maxsize=None)
def _caches(arch_id, batch, max_len):
    cfg, jcfg = configs.get_arch(arch_id), j_configs.get_arch(arch_id)
    enc = cfg.frontend_tokens if cfg.enc_dec else 0
    with FakeTensorMode():
        mine = T.init_cache(cfg, batch, max_len, torch.bfloat16, device="cpu", enc_len=enc)
    want = jax.eval_shape(lambda: JT.init_cache(jcfg, batch, max_len, jnp.bfloat16,
                                                enc_len=enc))
    return mine, want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_id", configs.ARCH_IDS)
def test_param_and_opt_specs_match_reference(arch_id, mesh):
    mine, want = _params(arch_id)
    assert _flat(mine).keys() == _flat(want).keys()
    m, jm = _meshes(mesh)
    _assert_same_specs(S.param_specs(mine, m), JS.param_specs(want, jm))
    _assert_same_specs(S.opt_specs(mine, m), JS.opt_specs(want, jm))
    if "pod" in MESHES[mesh][1]:
        _assert_same_specs(S.param_specs(mine, m, fed_axis="pod"),
                           JS.param_specs(want, jm, fed_axis="pod"))
        _assert_same_specs(S.opt_specs(mine, m, fed_axis="pod"),
                           JS.opt_specs(want, jm, fed_axis="pod"))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_id", configs.ARCH_IDS)
def test_cache_specs_match_reference(arch_id, mesh):
    """Eight slots of 4,096 and one long-context slot (the sequence-dim
    fallback), each package's own cache tree."""
    m, jm = _meshes(mesh)
    for batch, max_len in ((8, 4096), (1, 32768)):
        mine, want = _caches(arch_id, batch, max_len)
        assert {k: tuple(v.shape) for k, v in _flat(mine).items()} == \
            {k: tuple(v.shape) for k, v in _flat(want).items()}
        _assert_same_specs(S.cache_specs(mine, m), JS.cache_specs(want, jm))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_serve_arg_specs_match_reference(mesh):
    m, jm = _meshes(mesh)
    for b, s in ((256, 4096), (1, 524288), (3, 17), (8, 128)):
        batch = {"tokens": np.zeros((b, s), np.int32), "labels": np.zeros((b, s), np.int32),
                 "embeds": np.zeros((b, 4, 8), np.float32)}
        _assert_same_specs(S.batch_specs(batch, m), JS.batch_specs(batch, jm))
        args = {"token": np.zeros((b, 1), np.int32), "tokens": np.zeros((b, 16), np.int32),
                "i32": np.zeros((b,), np.int32), "bool": np.zeros((b,), bool),
                "f32": np.zeros((b,), np.float32)}
        _assert_same_specs(S.serve_arg_specs(args, m), JS.serve_arg_specs(args, jm))
    if "pod" in MESHES[mesh][1]:
        for g in (2, 3):
            fed = {"tokens": np.zeros((g, 32, 128), np.int32)}
            _assert_same_specs(S.batch_specs(fed, m, fed_axis="pod"),
                               JS.batch_specs(fed, jm, fed_axis="pod"))


EDGES = [
    ("final_norm", (8192,), 0),
    ("blocks/slot0/mixer/bq", (8, 8192), 1),
    ("blocks/slot0/mixer/A_log", (8, 256), 1),
    ("blocks/slot0/mixer/conv_b", (8, 1792), 1),
    ("blocks/slot0/mixer/conv_w", (8, 4, 1792), 1),
    ("blocks/slot0/mixer/in_proj", (8, 768, 3352), 1),
    ("blocks/slot0/mixer/out_proj", (8, 1536, 768), 1),
    ("blocks/slot0/mixer/wk", (8, 4096, 24), 1),       # MQA K/V narrower than the axis
    ("blocks/slot0/mixer/wv", (8, 6144, 64), 1),
    ("blocks/slot0/mixer/wk", (8, 15, 9), 1),          # nothing divides
    ("blocks/slot0/mixer/wq", (8, 8192, 8192), 1),
    ("blocks/slot0/mixer/wo", (8, 8192, 8192), 1),
    ("blocks/slot1/ffn/w_gate", (9, 16, 8192, 24576), 1),   # expert-parallel
    ("blocks/slot0/ffn/w_gate", (64, 8, 6144, 32768), 1),   # inside each expert
    ("blocks/slot0/ffn/w_down", (64, 8, 32768, 6144), 1),
    ("blocks/slot0/ffn/router", (64, 6144, 8), 1),
    ("embed", (151655, 896), 0),                       # odd vocab: model on d
    ("embed", (256206, 1024), 0),
    ("head", (896, 151655), 0),
    ("head", (1024, 256206), 0),
    ("blocks/slot0/mixer/unknown", (8, 64, 64), 1),
]


@pytest.mark.parametrize("path,shape,n_stack", EDGES,
                         ids=[f"{p.rsplit('/', 1)[-1]}-{'x'.join(map(str, s))}"
                              for p, s, _ in EDGES])
def test_spec_for_leaf_edges_match_reference(path, shape, n_stack):
    for mesh in MESHES:
        m, jm = _meshes(mesh)
        assert S.spec_for_leaf(path, shape, m, n_stack) == \
            tuple(JS.spec_for_leaf(path, shape, jm, n_stack)), mesh
    assert S.spec_for_leaf(path, shape, {"data": 16, "model": 16}, n_stack) == \
        S.spec_for_leaf(path, shape, S.MeshShape(("data", "model"), (16, 16)), n_stack)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_slot_rows_are_the_slot_blocks(mesh):
    """The serve engine's slot split (``slot_rows``) is the block that the
    per-step arrays' and the cache's specs give each rank where ``data``
    divides the slots, and every slot where it does not (3 slots; 1 slot,
    where the cache's specs fall back to the sequence dim)."""
    m, _ = _meshes(mesh)
    data = m.shape["data"]
    for batch in (data, 4 * data, 3, 1):
        rows = [S.slot_rows(batch, m, rank) for rank in range(m.size)]
        if batch % data:
            assert rows == [(0, batch)] * m.size, batch
            continue
        arg = S.serve_arg_specs({"t": np.zeros((batch, 1))}, m)["t"]
        kv = (2, batch, 16, 4, 8)
        for rank, (lo, hi) in enumerate(rows):
            assert S.block_slices((batch, 1), arg, m, rank)[0] == slice(lo, hi), (batch, rank)
            cut = S.block_slices(kv, S.cache_spec_for_leaf("k", kv, m), m, rank)
            assert cut[1] == slice(lo, hi), (batch, rank)
        assert {lo for lo, _ in rows} == set(range(0, batch, batch // data))


@pytest.mark.parametrize("mesh", ["1x2", "4x2", "2x16x16"])
def test_shard_then_gather_is_identity(mesh):
    """Every rank's block of a SMOKE model (torch) and of a numpy tree put
    back together equals the whole, bit for bit; blocks are copies."""
    m, _ = _meshes(mesh)
    cfg = configs.get_smoke("grok-1-314b")
    if mesh == "2x16x16":
        cfg = configs.get_smoke("seamless-m4t-large-v2")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = S.param_specs(params, m)
    blocks = [S.shard_tree(params, specs, m, rank) for rank in range(m.size)]
    back = S.gather_tree(blocks, specs, m)
    for path, leaf in _flat(params).items():
        assert torch.equal(_flat(back)[path], leaf), path
    first = _flat(blocks[0])
    cut = [p for p, spec in _flat(specs, True).items() if any(e is not None for e in spec)
           and first[p].numel() < _flat(params)[p].numel()]
    assert cut and all(first[p].data_ptr() != _flat(params)[p].data_ptr() for p in cut)
    if mesh != "2x16x16":
        tree = {"a": np.arange(64, dtype=np.float32).reshape(8, 8), "b": [np.ones(4)]}
        tspecs = {"a": ("data", "model"), "b": [(None,)]}
        nb = [S.shard_tree(tree, tspecs, m, rank) for rank in range(m.size)]
        back = S.gather_tree(nb, tspecs, m)
        np.testing.assert_array_equal(back["a"], tree["a"])
        np.testing.assert_array_equal(back["b"][0], tree["b"][0])


def test_shard_tree_refuses_indivisible_and_misfit_specs():
    m = S.MeshShape(("data", "model"), (1, 2))
    with pytest.raises(ValueError, match="does not divide"):
        S.shard_tree({"w": torch.zeros(3, 4)}, {"w": ("model", None)}, m, 0)
    with pytest.raises(ValueError, match="does not fit"):
        S.shard_tree({"w": torch.zeros(4)}, {"w": ("model", None)}, m, 0)
    with pytest.raises(ValueError, match="2 ranks"):
        S.gather_tree([{"w": torch.zeros(2)}], {"w": ("model",)}, m)


def test_meshes_and_hardware_constants():
    """The production shapes are the reference's (``repro.launch.mesh``);
    the host mesh clamps as the reference's (model to the ranks, data to
    ranks // model); HW holds the H100 SXM5's published numbers."""
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    cpu = torch.device("cpu")
    for data, model in ((1, 1), (4, 2), (1, 8), (0, 0)):
        mesh = make_host_mesh(data, model, device=cpu)
        assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
        assert mesh.axis.size == 1 and mesh.axis.sum(torch.ones(2)).tolist() == [1.0, 1.0]
    assert (HW.PEAK_FLOPS_BF16, HW.PEAK_FLOPS_TF32, HW.HBM_BW, HW.HBM_BYTES, HW.NVLINK_BW) == \
        (989e12, 494.7e12, 3.35e12, 80e9, 900e9)
