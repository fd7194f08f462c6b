"""The port's model axis (``dist.parallel``, the ``axis`` of
``models.layers`` and ``models.transformer``, ``dist.sharding``'s
``shard_tree``/``gather_tree``, ``convert.shard_lm_params``) against the JAX
package, on the CPU: every LM family's SMOKE model at model = 2, its two
ranks two ``torch.distributed`` processes over gloo (``file://`` init, one
thread each).

The weights are the reference's ``init_params(PRNGKey(0), float32)`` (QKV
biases drawn non-zero), saved once; each rank takes its block with
``shard_lm_params(tree, param_specs(abstract_params(cfg), mesh), mesh)``.
Tokens, frame and patch embeddings are made with numpy from a seed. Each
rank runs, for every case, ``loss_fn`` and ``forward_train``, four lockstep
``decode_step`` calls, and the chunked ``prefill_chunk`` of three rows of
mixed length (one empty) followed by a slot-mode decode step; rank 0 also
runs the same calls unsharded. The JAX package runs the same calls in this
process while the ranks run.

Contracts, with their tolerances:
- the sharded logits and loss against the JAX package's unsharded ones:
  1e-4 absolute and relative, the port's float32 contract; the prefill's
  cache, its ranks' blocks put back together with ``gather_tree``, too;
- against the port's own single-rank run: max|d| within 1e-5 of the
  largest magnitude;
- both ranks hold the same logits, bit for bit (every collective adds in
  rank order);
- each MoE layer's ``gate_idx`` and kept choices equal the single-rank
  run's (the routing and the capacity stay global);
- the cases cover GQA with K/V heads split (yi, qwen2.5 with biases), MQA
  with one K/V head (granite: ``wk``/``wv`` gathered before use), an odd
  vocab (511: ``embed`` on d, ``head`` gathered), tied embeddings (mamba2,
  the Mamba mixer replicated), the vision stub, expert-parallel MoE (grok,
  jamba), tensor-parallel MoE inside three experts, MLA (replicated) with
  shared experts (deepseek) and the encoder-decoder (``enc_out`` split on
  d in the cache).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as j_configs
from repro.dist.sharding import cache_specs as j_cache_specs
from repro.models import transformer as JT

from repro_torch.dist.sharding import MeshShape, cache_specs, gather_tree

from _torch_tp_cases import (B, CASES, CHUNK, MAX_LEN, MOE, PRE_LENS, chunk_tokens, chunks,
                             inputs, pre_embeds, smoke)
from _torch_threads import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 2
TOL = dict(atol=1e-4, rtol=1e-4)
SELF_TOL = 1e-5

_WORKER = textwrap.dedent("""
    import os, sys
    rank, world, init, out, src, here = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                         sys.argv[4], sys.argv[5], sys.argv[6])
    sys.path[:0] = [src, here]
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from _torch_tp_cases import (B, CASES, CHUNK, MAX_LEN, PRE_LENS, chunk_tokens, chunks,
                                 pre_embeds, smoke)
    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_params_from_numpy, shard_lm_params
    from repro_torch.dist.sharding import param_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    routes = []
    real_route = L.moe_route

    def spy(p, x, cfg, axis=None):
        got = real_route(p, x, cfg, axis)
        routes.append((got[1].numpy(), got[3].numpy()))
        return got

    L.moe_route = spy

    def unflatten(flat):
        tree = {}
        for key, value in flat.items():
            node = tree
            *parts, last = key.split("/")
            for part in parts:
                node = node.setdefault(part, {})
            node[last] = value
        return tree

    def encoder_into(cfg, params, cache, emb, axis):
        enc = T._run_encoder(cfg, params, emb, remat=False, axis=axis)
        width = cache["enc_out"].shape[-1]
        if width != enc.shape[-1]:                 # enc_out split on d
            lo = axis.span(enc.shape[-1])[0]
            enc = enc[..., lo:lo + width]
        cache["enc_out"] = enc.contiguous()

    def run(cfg, params, x, axis):
        res = {"param_elems": sum(v.numel() for v in leaves_of(params))}
        calls = axis.stats["calls"] if axis is not None else 0
        t = lambda a: torch.from_numpy(np.asarray(a))
        with torch.no_grad():
            emb = t(x["embeds"]) if "embeds" in x else None
            batch = {"tokens": t(x["tokens"]), "labels": t(x["labels"])}
            if emb is not None:
                batch["embeds"] = emb
            res["loss"] = T.loss_fn(cfg, params, batch, remat=False, axis=axis).numpy()
            del routes[:]
            res["fwd"] = T.forward_train(cfg, params, batch["tokens"], emb, remat=False,
                                         axis=axis)[0].numpy()
            for i, (idx, keep) in enumerate(routes):
                res[f"route{i}"], res[f"keep{i}"] = idx, keep
            cache = T.init_cache(cfg, B, MAX_LEN, device="cpu", axis=axis)
            if cfg.enc_dec:
                encoder_into(cfg, params, cache, emb, axis)
            steps = []
            for s in range(x["dec"].shape[1]):
                lg, cache = T.decode_step(cfg, params, cache, t(x["dec"][:, s:s + 1]), axis=axis)
                steps.append(lg.numpy())
            res["dec"] = np.stack(steps)
            cache = T.init_cache(cfg, len(PRE_LENS), MAX_LEN, device="cpu", axis=axis)
            if cfg.enc_dec:
                encoder_into(cfg, params, cache, t(pre_embeds(x["embeds"])), axis)
            pre = []
            for pos, nv in chunks(PRE_LENS, CHUNK):
                lg, cache = T.prefill_chunk(cfg, params, cache,
                                            t(chunk_tokens(x["pre"], pos, nv, CHUNK)), t(pos),
                                            t(nv), axis=axis)
                pre.append(lg.numpy())
            res["pre"] = np.stack(pre)
            for slot, leaves in cache["slots"].items():
                for name, value in leaves.items():
                    res[f"cache/{slot}/{name}"] = value.numpy()
            lengths = np.asarray(PRE_LENS, np.int32)
            lg, _ = T.decode_step(cfg, params, cache, t(x["post"]), positions=t(lengths),
                                  active=t(lengths > 0), axis=axis)
            res["post"] = lg.numpy()
        res["collectives"] = (axis.stats["calls"] if axis is not None else 0) - calls
        return res

    def leaves_of(tree):
        if isinstance(tree, dict):
            return [leaf for v in tree.values() for leaf in leaves_of(v)]
        return [tree]

    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(1, world, device=cpu, group=dist.group.WORLD)
        for name, (arch, over) in CASES.items():
            cfg = smoke(get_smoke, arch, over)
            tree = unflatten(dict(np.load(os.path.join(out, f"{name}.params.npz"))))
            x = dict(np.load(os.path.join(out, f"{name}.inputs.npz")))
            specs = param_specs(T.abstract_params(cfg), mesh)
            sharded = run(cfg, shard_lm_params(tree, specs, mesh, "cpu"), x, mesh.axis)
            np.savez(os.path.join(out, f"{name}.rank{rank}.npz"), **sharded)
            if rank == 0:
                single = run(cfg, lm_params_from_numpy(tree, "cpu"), x, None)
                np.savez(os.path.join(out, f"{name}.single.npz"), **single)
        dist.barrier()
    finally:
        dist.destroy_process_group()
""")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _j_params(jcfg):
    """The reference's float32 init, its QKV biases drawn non-zero."""
    tree = jax.tree_util.tree_map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0),
                                                           jnp.float32))
    rng = np.random.default_rng(4)

    def draw(node):
        if isinstance(node, dict):
            for bias in ("bq", "bk", "bv"):
                if bias in node:
                    node[bias] = (0.2 * rng.standard_normal(node[bias].shape)).astype(
                        np.float32)
            for value in node.values():
                draw(value)

    draw(tree)
    return tree


def _jax_run(jcfg, jp, x):
    """The reference's unsharded calls on the same inputs."""
    res = {}
    j = jnp.asarray
    emb = j(x["embeds"]) if "embeds" in x else None
    batch = {"tokens": j(x["tokens"]), "labels": j(x["labels"])}
    if emb is not None:
        batch["embeds"] = emb
    res["loss"] = np.asarray(JT.loss_fn(jcfg, jp, batch, remat=False))
    res["fwd"] = np.asarray(JT.forward_train(jcfg, jp, batch["tokens"], emb, remat=False)[0])
    cache = JT.init_cache(jcfg, B, MAX_LEN, jnp.float32)
    if jcfg.enc_dec:
        cache["enc_out"] = JT._run_encoder(jcfg, jp, emb, remat=False)
    steps = []
    for s in range(x["dec"].shape[1]):
        lg, cache = JT.decode_step(jcfg, jp, cache, j(x["dec"][:, s:s + 1]))
        steps.append(np.asarray(lg))
    res["dec"] = np.stack(steps)
    cache = JT.init_cache(jcfg, 3, MAX_LEN, jnp.float32)
    if jcfg.enc_dec:
        cache["enc_out"] = JT._run_encoder(jcfg, jp, j(pre_embeds(x["embeds"])), remat=False)
    pre = []
    for pos, nv in chunks(PRE_LENS, CHUNK):
        lg, cache = JT.prefill_chunk(jcfg, jp, cache, j(chunk_tokens(x["pre"], pos, nv, CHUNK)),
                                     j(pos), j(nv))
        pre.append(np.asarray(lg))
    res["pre"] = np.stack(pre)
    res["cache"] = jax.tree_util.tree_map(np.asarray, cache)
    lengths = np.asarray(PRE_LENS, np.int32)
    lg, _ = JT.decode_step(jcfg, jp, cache, j(x["post"]), positions=j(lengths),
                           active=j(lengths > 0))
    res["post"] = np.asarray(lg)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (jax, rank 0, rank 1, single-rank)}: the ranks run in two
    processes while the reference runs here."""
    out = tmp_path_factory.mktemp("tp")
    jcfgs, inputs_of = {}, {}
    for name, (arch, over) in CASES.items():
        jcfgs[name] = smoke(j_configs.get_smoke, arch, over)
        tree = _j_params(jcfgs[name])
        np.savez(out / f"{name}.params.npz", **_flatten(tree))
        inputs_of[name] = (tree, inputs(jcfgs[name], 7))
        np.savez(out / f"{name}.inputs.npz", **inputs_of[name][1])
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), str(WORLD),
                               str(out / "init"), str(out), os.path.join(ROOT, "src"),
                               os.path.dirname(os.path.abspath(__file__))],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(WORLD)]
    try:
        want = {name: _jax_run(jcfgs[name], jax.tree_util.tree_map(jnp.asarray, tree), x)
                for name, (tree, x) in inputs_of.items()}
        errors = []
        for rank, proc in enumerate(procs):
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                errors.append(f"rank {rank}: {err[-3000:]}")
    finally:
        for proc in procs:
            proc.kill()
    assert not errors, "\n".join(errors)
    return {name: (want[name], *(dict(np.load(out / f"{name}.{who}.npz"))
                                 for who in ("rank0", "rank1", "single")))
            for name in CASES}


OUTPUTS = ("loss", "fwd", "dec", "pre", "post")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_jax(runs, name):
    """Forward and loss, decode, chunked prefill and the decode after it, at
    model = 2, within 1e-4 of the reference's unsharded calls."""
    want, got, _, _ = runs[name]
    for key in OUTPUTS:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_single_rank(runs, name):
    """The same calls within 1e-5 of the largest magnitude of the port's
    own unsharded run."""
    _, got, _, single = runs[name]
    for key in OUTPUTS:
        scale = float(np.abs(single[key]).max())
        assert float(np.abs(got[key] - single[key]).max()) <= SELF_TOL * scale, key


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_equal_bits(runs, name):
    """Both ranks hold the same outputs, bit for bit; each held less than the
    whole model and ran collectives."""
    _, rank0, rank1, single = runs[name]
    for key in OUTPUTS:
        np.testing.assert_array_equal(rank0[key], rank1[key], err_msg=key)
    for rank in (rank0, rank1):
        assert int(rank["param_elems"]) < int(single["param_elems"])
        assert int(rank["collectives"]) > 0 and int(single["collectives"]) == 0


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_cache_blocks_gather_to_jax(runs, name):
    """Each rank's block of the prefill cache (the K/V heads of its own
    heads, the replicated Mamba and MLA state), put back together with
    ``gather_tree`` by ``cache_specs``, within 1e-4 of the reference's
    cache; the specs equal the reference's on the same cache."""
    want, rank0, rank1, _ = runs[name]
    mesh = MeshShape(("data", "model"), (1, WORLD))
    j_mesh = jax.sharding.AbstractMesh((1, WORLD), ("data", "model"))
    full = want["cache"]["slots"]
    specs = cache_specs({"slots": full}, mesh)["slots"]
    j_specs = j_cache_specs({"slots": full}, j_mesh)["slots"]
    blocks = []
    for rank in (rank0, rank1):
        tree = {}
        for key, value in rank.items():
            if key.startswith("cache/"):
                _, slot, leaf = key.split("/")
                tree.setdefault(slot, {})[leaf] = value
        blocks.append(tree)
    got = gather_tree(blocks, specs, mesh)
    for slot, leaves in full.items():
        for leaf, value in leaves.items():
            assert specs[slot][leaf] == tuple(j_specs[slot][leaf]), (slot, leaf)
            np.testing.assert_allclose(got[slot][leaf], value, err_msg=f"{slot}/{leaf}", **TOL)


@pytest.mark.parametrize("name", MOE)
def test_moe_routing_is_global(runs, name):
    """Each MoE layer's gate_idx and kept choices in the sharded forward
    equal the single-rank run's; the experts split as the case says."""
    _, got, _, single = runs[name]
    keys = sorted(k for k in single if k.startswith("route"))
    assert keys and keys == sorted(k for k in got if k.startswith("route"))
    for key in keys:
        np.testing.assert_array_equal(got[key], single[key], err_msg=key)
        np.testing.assert_array_equal(got[key.replace("route", "keep")],
                                      single[key.replace("route", "keep")])
