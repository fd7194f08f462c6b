"""The DFedRW pod deployment on a pod mesh with a data axis
(``launch.mesh.make_pod_mesh(2)`` over four ranks, ``dist.make_fed_train_step``
on it, the per-data-shard wire of ``dist.gossip``, ``launch.train pod --fed``
under ``torchrun``) against the JAX package, on the CPU.

Four ``torch.distributed`` processes over gloo (``file://`` init, one
thread each, deterministic algorithms) form the reference's ``(2, 2, 1)``
mesh: rank r at pod r // 2 and data index r % 2. Each rank keeps its
blocks of its pod's weights (``param_specs`` on the pod's host mesh; the
velocity by ``opt_specs``) and of its pod's batch (``batch_specs``), and
runs every case for yi-6b and mamba2-130m SMOKE: 2 pods x 4 rows x 32
tokens, 3 steps, a ring gossip every 2 steps. The reference runs its own
``make_fed_train_step``, jitted, on ``jax.sharding.Mesh(devices[:4].reshape(2,
2, 1), ("pod", "data", "model"))`` under eight forced host devices, one
subprocess a model (``_ORACLE``), from the same weights and batches. At
bits 8 the port takes the reference's own uniforms: the step's key folded
by leaf, offset and pod, drawn at ``(1, *block)``, the same for a pod's
two data shards (made in this process before the ranks start). While the
ranks and the reference run, ``launch.train pod --fed --pods 2`` runs under
``torchrun --nproc-per-node 4``.

Contracts, with their tolerances (``tests/test_torch_fed.py``'s):
- the mean losses within ``LOSS_RTOL`` (relative) of the reference's, the
  same on every rank; the gathered parameters within ``STEP_TOL`` of each
  leaf's largest magnitude at bits 32, and at bits 8 the flip contract
  (``STEP_TOL`` plus a grid cell times the mixing weight an offset a
  gossip, at most ``FLIP_SHARE`` of the elements beyond ``STEP_TOL``);
- a negative control: the same bits-8 gossip quantizing each pod's whole
  gathered leaf (one header a leaf, with the same uniforms) misses that
  contract on some data-split leaf;
- a leaf that ``param_specs`` replicates over data is bit-equal on a pod's
  two data ranks, and the ranks' gathered parameters are equal;
- ``walk_permute_batch`` over the gossip group equals the reference's
  ``walk_permute_batch(..., axis="pod")`` on the blocks, bit for bit;
- the scheduled step fed the static pattern equals the static step, bit
  for bit;
- the bytes the ranks' gossip exchanges send are ``gossip_wire_bits`` of a
  rank's block layout (one header a (block, leaf), a replicated leaf once a
  data rank), at bits 32 and 8;
- 3 steps, ``save_checkpoint`` of the gathered tree, a restore into blocks
  and 3 more steps equal 6 uninterrupted steps, bit for bit (parameters and
  velocity; the counterpart of the reference's
  ``test_fed_restore_then_continue_multidevice``);
- the launcher prints the losses of the step driven directly on its
  weights, batches and pod-seeded wire generator, and equal digests on a
  pod's ranks.
"""
import json
import os
import re
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke as j_get_smoke
from repro.models import transformer as JT

from repro_torch.configs import get_smoke
from repro_torch.core.flatten import make_flat_spec
from repro_torch.dist.gossip import GossipConfig, gossip_wire_bits, mixing_weights
from repro_torch.dist.sharding import block_slices, gather_tree, param_specs
from repro_torch.models import transformer as T

from _torch_fed_data_cases import (ARCHS, BITS, DATA, EVERY, GOSSIPS, KEY_SEED, LAUNCH_ARCH,
                                   LR_R, PODS, ROWS, SEQ, STEPS, WORLD, flatten, unflatten,
                                   walk_input)
from _torch_threads import torch_threads  # noqa: F401
from test_torch_fed import FLIP_SHARE, LOSS_RTOL, STEP_TOL, flip_leaf

ROOT = os.path.join(os.path.dirname(__file__), "..")
HERE = os.path.dirname(os.path.abspath(__file__))
MESH = {"pod": PODS, "data": DATA, "model": 1}
HOST = {"data": DATA, "model": 1}

_ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    arch, out, src, here = sys.argv[1:5]
    sys.path[:0] = [src, here]
    import jax, jax.numpy as jnp, numpy as np
    from _torch_fed_data_cases import (BITS, EVERY, KEY_SEED, LR_R, PODS, DATA, STEPS, batches,
                                       flatten, unflatten)
    from repro.configs import get_smoke
    from repro.dist.gossip import GossipConfig, walk_permute_batch
    from repro.dist.sharding import batch_specs, named
    from repro.dist.steps import make_fed_train_step

    cfg = get_smoke(arch)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:PODS * DATA]).reshape(PODS, DATA, 1),
                             ("pod", "data", "model"))
    base = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(np.load(f"{out}/{arch}.params.npz"))))
    res = {}
    for bits in BITS:
        gossip = GossipConfig(axis="pod", topology="ring", every=EVERY, quant_bits=bits)
        fn, p_specs, _ = make_fed_train_step(cfg, mesh, gossip, lr_r=LR_R, remat=False,
                                             dtype=jnp.float32)
        params = jax.device_put(jax.tree_util.tree_map(
            lambda l: jnp.broadcast_to(l, (PODS, *l.shape)).copy(), base), named(p_specs, mesh))
        vel = jax.tree_util.tree_map(jnp.zeros_like, params)
        jitted = jax.jit(fn)
        key, losses = jax.random.PRNGKey(KEY_SEED), []
        with mesh:
            for step, toks in enumerate(batches(cfg.vocab)):
                batch = {"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
                         "labels": jnp.asarray(toks[..., 1:], jnp.int32)}
                batch = jax.device_put(batch, named(batch_specs(batch, mesh, fed_axis="pod"),
                                                    mesh))
                key, sub = jax.random.split(key)
                params, vel, loss = jitted(params, vel, batch, jnp.int32(step), sub)
                losses.append(float(loss))
        res[f"{bits}/losses"] = np.array(losses)
        res.update({f"{bits}/p/{k}": np.asarray(v) for k, v in flatten(params).items()})
    walk = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(np.load(f"{out}/{arch}.walk.npz"))))
    walk = jax.device_put(walk, named(p_specs, mesh))
    moved = jax.jit(lambda t: walk_permute_batch(t, p_specs, mesh, "pod", 1))(walk)
    res.update({f"walk/{k}": np.asarray(v) for k, v in flatten(moved).items()})
    np.savez(f"{out}/{arch}.oracle.npz", **res)
""")

_WORKER = textwrap.dedent("""
    import os, sys
    rank, world, init, out, src, here = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                         sys.argv[4], sys.argv[5], sys.argv[6])
    sys.path[:0] = [src, here]
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    from _torch_fed_data_cases import (ARCHS, CKPT_AT, CKPT_STEPS, EVERY, GOSSIPS, LAUNCH_ARCH,
                                       LR_R, PODS, STEPS, batches, ckpt_batch, flatten,
                                       unflatten)
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_smoke
    from repro_torch.convert import shard_lm_params, shard_opt_state
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.dist import GossipConfig, make_fed_train_step, walk_permute_batch
    from repro_torch.dist.gossip import mix_into
    from repro_torch.dist.sharding import batch_specs, opt_specs, param_specs, shard_tree
    from repro_torch.dist.steps import whole_params
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")

    def arrays(tree, prefix):
        return {f"{prefix}/{k}": v.detach().numpy().copy() for k, v in flatten(tree).items()}

    def zeros_like(tree):
        return unflatten({k: np.zeros(np.shape(v), np.float32) for k, v in flatten(tree).items()})

    def pod_batch(toks):
        # this rank's rows of its pod's batch, and the pod batch's specs
        toks = torch.as_tensor(toks[mesh.pod])
        batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
        spec = batch_specs(batch, host)
        return shard_tree(batch, spec, host), spec

    def cut_into(blocks, whole, specs):
        # write this rank's blocks of the whole tree ``whole`` over ``blocks``
        for leaf, new in zip(tree_leaves(blocks), tree_leaves(shard_tree(whole, specs, host))):
            leaf.copy_(new)

    def stacked(blocks, specs):
        # the pods' whole trees stacked, (PODS, ...) a leaf, gathered over both groups
        whole = whole_params(blocks, specs, host)
        return unflatten({k: mesh.pod_axis.all_gather(v[None], 0)
                          for k, v in flatten(whole).items()})

    def run(cfg, tree, bits, *, flags=None, uniforms=None, generator=None, whole_leaf=None):
        # STEPS steps of the fed step from the whole tree ``tree`` (numpy or tensors):
        # the static step, or the scheduled one fed ``flags``; ``whole_leaf``: a
        # gossip of the pods' whole gathered leaves with those uniforms in its place
        gossip = GossipConfig(topology="ring", every=EVERY, quant_bits=bits)
        sched = flags is not None or whole_leaf is not None
        step_fn, _, _ = make_fed_train_step(cfg, mesh, gossip, lr_r=LR_R, remat=False,
                                            scheduled=sched)
        specs = param_specs(T.abstract_params(cfg), host)
        params = shard_lm_params(tree, specs, host, "cpu")
        vel = shard_opt_state(zeros_like(tree), host, "cpu")
        losses, wire = [], []
        for step, toks in enumerate(batches(cfg.vocab)):
            batch, b_spec = pod_batch(toks)
            sent = mesh.gossip_axis.stats["bytes"]
            extra = ()
            if sched:
                extra = (bool(flags[step]) if flags is not None else False,)
            params, vel, loss = step_fn(params, vel, batch, step, *extra, uniforms=uniforms,
                                        generator=generator, batch_spec=b_spec)
            if whole_leaf is not None and step in GOSSIPS:
                whole = whole_params(params, specs, host)
                mix_into(whole, gossip, group=mesh.gossip_axis, uniforms=whole_leaf)
                cut_into(params, whole, specs)
            wire.append(mesh.gossip_axis.stats["bytes"] - sent)
            losses.append(float(loss))
        return {"losses": np.array(losses), "wire": np.array(wire), "params": params,
                "vel": vel}

    def file_uniforms(arch):
        u = dict(np.load(os.path.join(out, f"{arch}.uniforms.npz")))
        return lambda li, oi, pod: torch.from_numpy(u[f"{li}/{oi}/{pod}"])

    def whole_leaf_uniforms(arch, tree):
        # the pod's uniforms of each block, laid side by side over the data-split dim
        u = dict(np.load(os.path.join(out, f"{arch}.uniforms.npz")))
        shapes = [np.shape(leaf) for leaf in tree_leaves(tree)]

        def uniforms(li, oi, pod):
            block = u[f"{li}/{oi}/{pod}"][0]
            for dim, (b, whole) in enumerate(zip(block.shape, shapes[li])):
                if b != whole:
                    block = np.concatenate([block] * (whole // b), dim)
            return torch.from_numpy(block)
        return uniforms

    def checkpoint_case(cfg, tree, arch):
        # 3 steps, save the gathered tree, 3 more (run A); restore into blocks and
        # take the last 3 again (run B)
        gossip = GossipConfig(topology="ring", every=EVERY, quant_bits=8)
        step_fn, _, _ = make_fed_train_step(cfg, mesh, gossip, lr_r=LR_R, remat=False)
        specs = param_specs(T.abstract_params(cfg), host)
        o_specs = opt_specs(T.abstract_params(cfg), host)
        params = shard_lm_params(tree, specs, host, "cpu")
        vel = shard_opt_state(zeros_like(tree), host, "cpu")
        shapes = [leaf.shape for leaf in tree_leaves(params)]

        def go(params, vel, lo, hi):
            for step in range(lo, hi):
                def uniforms(li, oi, pod, step=step):
                    g = torch.Generator().manual_seed(10 ** 6 * step + 1000 * li + 100 * oi + pod)
                    return torch.rand(shapes[li], generator=g)
                batch, b_spec = pod_batch(ckpt_batch(cfg.vocab, step))
                params, vel, _ = step_fn(params, vel, batch, step, uniforms=uniforms,
                                         batch_spec=b_spec)
            return params, vel

        params, vel = go(params, vel, 0, CKPT_AT)
        saved = {"params": stacked(params, specs), "vel": stacked(vel, o_specs)}
        directory = os.path.join(out, f"{arch}.ckpt")
        if rank == 0:
            save_checkpoint(directory, CKPT_AT, saved)
        dist.barrier()
        params, vel = go(params, vel, CKPT_AT, CKPT_STEPS)
        restored, meta = load_checkpoint(directory, saved)
        mine = {name: {k: v[mesh.pod] for k, v in flatten(t).items()}
                for name, t in restored.items()}
        rp = shard_lm_params(unflatten(mine["params"]), specs, host, "cpu")
        rv = shard_lm_params(unflatten(mine["vel"]), o_specs, host, "cpu")
        rp, rv = go(rp, rv, meta["step"], CKPT_STEPS)
        return {**arrays(params, "ckpt/a/p"), **arrays(vel, "ckpt/a/v"),
                **arrays(rp, "ckpt/b/p"), **arrays(rv, "ckpt/b/v")}

    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    try:
        mesh = make_pod_mesh(PODS, device=cpu, group=dist.group.WORLD)
        host = mesh.host
        for arch in ARCHS:
            cfg = get_smoke(arch)
            tree = unflatten(dict(np.load(os.path.join(out, f"{arch}.params.npz"))))
            res = {"coords": np.array([mesh.pod, host.data_axis.rank])}
            for bits in (32, 8):
                got = run(cfg, tree, bits, uniforms=file_uniforms(arch) if bits < 32 else None)
                res[f"{bits}/losses"], res[f"{bits}/wire"] = got["losses"], got["wire"]
                res.update(arrays(got["params"], f"{bits}/p"))
                res.update(arrays(got["vel"], f"{bits}/v"))
            flags = [(s + 1) % EVERY == 0 for s in range(STEPS)]
            got = run(cfg, tree, 8, flags=flags, uniforms=file_uniforms(arch))
            res["sched/losses"] = got["losses"]
            res.update(arrays(got["params"], "sched/p"))
            res.update(arrays(got["vel"], "sched/v"))
            got = run(cfg, tree, 8, whole_leaf=whole_leaf_uniforms(arch, tree))
            res["whole/losses"] = got["losses"]
            res.update(arrays(got["params"], "whole/p"))
            walk = unflatten({k: v[mesh.pod] for k, v in
                              dict(np.load(os.path.join(out, f"{arch}.walk.npz"))).items()})
            blocks = shard_lm_params(walk, param_specs(T.abstract_params(cfg), host), host,
                                     "cpu")
            res.update(arrays(walk_permute_batch(blocks, mesh.gossip_axis, 1), "walk"))
            res.update(checkpoint_case(cfg, tree, arch))
            if arch == LAUNCH_ARCH:     # the launcher's run, driven directly
                torch.use_deterministic_algorithms(False)
                init_tree = T.init_params(cfg, torch.Generator(device=cpu).manual_seed(0),
                                          device=cpu)
                got = run(cfg, init_tree, 8,
                          generator=torch.Generator(device=cpu).manual_seed(1 + mesh.pod))
                torch.use_deterministic_algorithms(True)
                res["launch/losses"] = got["losses"]
            np.savez(os.path.join(out, f"{arch}.rank{rank}.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()
""")


@jax.jit
def _fold(key, li, oi, me):
    for salt in (li, oi, me):
        key = jax.random.fold_in(key, salt)
    return key


def _leaf_specs(cfg):
    """(path, shape, spec on the pod's host mesh) of every leaf, in sorted
    path order (the gossip's leaf numbering)."""
    abstract = flatten(T.abstract_params(cfg))
    specs = flatten(param_specs(T.abstract_params(cfg), HOST))
    return [(path, tuple(abstract[path].shape), specs[path]) for path in sorted(abstract)]


def _block(shape, spec):
    return tuple(cut.stop - cut.start for cut in block_slices(shape, spec, HOST, 0))


def _ref_uniforms(arch):
    """The reference's uniforms of the gossips' wire tensors (li, oi, pod):
    the step's key folded by li, oi and the pod (not the data index), drawn
    at the rank's block shape (1, *block)."""
    leaves = _leaf_specs(get_smoke(arch))
    offsets = GossipConfig(topology="ring").offsets(PODS)
    key, out = jax.random.PRNGKey(KEY_SEED), {}
    for step in range(STEPS):
        key, sub = jax.random.split(key)
        if step not in GOSSIPS:
            continue
        assert len(GOSSIPS) == 1          # one gossip's uniforms a leaf, offset and pod
        for li, (_, shape, spec) in enumerate(leaves):
            for oi in range(len(offsets)):
                for pod in range(PODS):
                    out[f"{li}/{oi}/{pod}"] = np.asarray(jax.random.uniform(
                        _fold(sub, li, oi, pod), (1, *_block(shape, spec)), dtype=jnp.float32))
    return out


def _spawn(cmd, env, **kw):
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, **kw)


def _wait(procs, timeout):
    errors = []
    try:
        for label, proc in procs.items():
            _, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                errors.append(f"{label}: {err[-3000:]}")
    finally:
        for proc in procs.values():
            proc.kill()
    assert not errors, "\n".join(errors)


def _launcher(env):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc-per-node",
           str(WORLD), "--master-addr", "127.0.0.1", "--master-port", str(port), "-m",
           "repro_torch.launch.train", "pod", "--arch", LAUNCH_ARCH, "--smoke", "--fed",
           "--pods", str(PODS), "--bits", "8", "--gossip-every", str(EVERY), "--steps",
           str(STEPS), "--batch", str(ROWS), "--seq", str(SEQ), "--lr_r", str(LR_R),
           "--device", "cpu"]
    return subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{arch: (the reference's results, [each rank's results])} and the
    launcher's stdout: the ranks, the launcher and the reference's
    subprocesses run at once."""
    out = tmp_path_factory.mktemp("fed_data")
    for arch in ARCHS:
        tree = jax.tree_util.tree_map(np.asarray, JT.init_params(
            j_get_smoke(arch), jax.random.PRNGKey(0), jnp.float32))
        np.savez(out / f"{arch}.params.npz", **flatten(tree))
        np.savez(out / f"{arch}.walk.npz", **walk_input(tree))
        np.savez(out / f"{arch}.uniforms.npz", **_ref_uniforms(arch))
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    oracles = {arch: _spawn([sys.executable, "-c", _ORACLE, arch, str(out), src, HERE],
                            dict(env, JAX_PLATFORMS="cpu")) for arch in ARCHS}
    ranks = {f"rank {r}": _spawn([sys.executable, "-c", _WORKER, str(r), str(WORLD),
                                  str(out / "init"), str(out), src, HERE], env)
             for r in range(WORLD)}
    launched = _launcher(dict(env, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])))
    try:
        launch_out, launch_err = launched.communicate(timeout=300)
    finally:
        launched.kill()
    assert launched.returncode == 0, launch_err[-3000:]
    _wait(ranks, 300)
    _wait(oracles, 300)
    got = {arch: (dict(np.load(out / f"{arch}.oracle.npz")),
                  [dict(np.load(out / f"{arch}.rank{r}.npz")) for r in range(WORLD)])
           for arch in ARCHS}
    return got, launch_out


def _by(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _gathered(ranks, prefix, cfg):
    """{path: (PODS, ...) leaf} from the ranks' blocks: each rank's block with
    a leading pod dimension, put together by ``gather_tree`` on the pod
    mesh's specs."""
    specs = param_specs(T.abstract_params(cfg), MESH, fed_axis="pod")
    blocks = [unflatten({k: v[None] for k, v in _by(res, prefix).items()}) for res in ranks]
    return flatten(gather_tree(blocks, specs, MESH))


def _data_split(cfg):
    return {path for path, _, spec in _leaf_specs(cfg) if "data" in spec}


def _flip_contract(got, want, bits, per_leaf=False):
    """The bits-8 contract of ``tests/test_torch_fed.py`` (``flip_leaf``):
    (every leaf within STEP_TOL plus the flips' cells, the share of
    elements beyond STEP_TOL), or each leaf's pair with ``per_leaf``."""
    gossip = GossipConfig(topology="ring", every=EVERY, quant_bits=bits)
    w = mixing_weights(PODS, gossip)[1][1]
    per_cell = len(GOSSIPS) * len(gossip.offsets(PODS)) * w * (1 + 1e-5)
    out = {path: flip_leaf(got[path], value, bits, per_cell) for path, value in want.items()}
    if per_leaf:
        return {path: (ok, n / want[path].size) for path, (ok, n) in out.items()}
    return (all(ok for ok, _ in out.values()),
            sum(n for _, n in out.values()) / sum(v.size for v in want.values()))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", BITS)
def test_losses_match_reference(runs, arch, bits):
    """Every rank's mean losses within LOSS_RTOL of the reference's on the
    (2, 2, 1) mesh, and equal on every rank."""
    want, ranks = runs[0][arch]
    for res in ranks:
        np.testing.assert_array_equal(res[f"{bits}/losses"], ranks[0][f"{bits}/losses"])
    np.testing.assert_allclose(ranks[0][f"{bits}/losses"], want[f"{bits}/losses"],
                               rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", BITS)
def test_params_match_reference(runs, arch, bits):
    """The gathered parameters: within STEP_TOL of each leaf's largest
    magnitude at bits 32; the flip contract at bits 8, where each data
    shard is a wire tensor of its own."""
    want, ranks = runs[0][arch]
    cfg = get_smoke(arch)
    got = _gathered(ranks, f"{bits}/p/", cfg)
    ref = _by(want, f"{bits}/p/")
    assert sorted(got) == sorted(ref) and _data_split(cfg)
    for path, value in ref.items():
        assert got[path].shape == value.shape and np.isfinite(got[path]).all(), path
    if bits == 32:
        for path, value in ref.items():
            d = float(np.abs(got[path] - value).max())
            assert d <= STEP_TOL * float(np.abs(value).max()), f"{path}: max|d|={d:.3e}"
        return
    within, share = _flip_contract(got, ref, bits)
    assert within and share <= FLIP_SHARE, f"within {within}, {share:.2e} beyond STEP_TOL"


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_leaf_wire_misses_reference(runs, arch):
    """The negative control: the bits-8 gossip on each pod's whole gathered
    leaf (one header a leaf, the blocks' own uniforms side by side) fails
    the flip contract on some data-split leaf (the replicated leaves cross
    the same wire, and move only through the next step's gradients)."""
    want, ranks = runs[0][arch]
    cfg = get_smoke(arch)
    got = _gathered(ranks, "whole/p/", cfg)
    verdicts = _flip_contract(got, _by(want, "8/p/"), 8, per_leaf=True)
    split = _data_split(cfg)
    missed = {path for path, (ok, share) in verdicts.items() if not ok or share > FLIP_SHARE}
    assert missed & split, verdicts


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaves_bit_equal_in_a_pod(runs, arch):
    """A leaf that ``param_specs`` replicates over data is the same bits on
    a pod's two data ranks after bits-8 gossip; the data-split leaves'
    blocks differ."""
    _, ranks = runs[0][arch]
    cfg = get_smoke(arch)
    split = _data_split(cfg)
    assert [res["coords"].tolist() for res in ranks] == [[r // DATA, r % DATA]
                                                         for r in range(WORLD)]
    for pod in range(PODS):
        a, b = ranks[DATA * pod], ranks[DATA * pod + 1]
        for path, value in _by(a, "8/p/").items():
            if path in split:
                assert not np.array_equal(value, b[f"8/p/{path}"]), path
            else:
                np.testing.assert_array_equal(value, b[f"8/p/{path}"], err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_walk_permute_batch_matches_reference(runs, arch):
    """``walk_permute_batch`` over the gossip group moves each rank's blocks
    to pod + 1 at its data index: the reference's hop on the (2, 2, 1)
    mesh, bit for bit."""
    want, ranks = runs[0][arch]
    got = _gathered(ranks, "walk/", get_smoke(arch))
    ref = _by(want, "walk/")
    assert sorted(got) == sorted(ref)
    for path, value in ref.items():
        np.testing.assert_array_equal(got[path], value, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduled_step_equals_static(runs, arch):
    """The scheduled step fed the static pattern: the static step's losses,
    parameters and velocity, bit for bit, on every rank."""
    _, ranks = runs[0][arch]
    for res in ranks:
        np.testing.assert_array_equal(res["sched/losses"], res["8/losses"])
        for kind in ("p", "v"):
            for path, value in _by(res, f"8/{kind}/").items():
                np.testing.assert_array_equal(res[f"sched/{kind}/{path}"], value, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", BITS)
def test_gossip_wire_bits_counts_the_exchanges(runs, arch, bits):
    """The bytes the ranks' gossip exchanges send in a gossip are
    ``gossip_wire_bits`` of one rank's block layout over the (2, 2, 1)
    mesh: one header a (block, leaf) at bits 8, a replicated leaf once a
    data rank; nothing crosses between gossips."""
    _, ranks = runs[0][arch]
    cfg = get_smoke(arch)
    blocks = {path: np.zeros(_block(shape, spec), np.float32)
              for path, shape, spec in _leaf_specs(cfg)}
    spec = make_flat_spec(unflatten(blocks))
    cfg_g = GossipConfig(topology="ring", quant_bits=bits)
    per_gossip = gossip_wire_bits(spec, PODS, cfg_g, data=DATA) / 8
    sent = np.sum([res[f"{bits}/wire"] for res in ranks], axis=0)
    assert sent.tolist() == [per_gossip if s in GOSSIPS else 0 for s in range(STEPS)]
    whole = make_flat_spec(T.abstract_params(cfg))
    assert per_gossip > gossip_wire_bits(whole, PODS, cfg_g) / 8


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restore_then_continue(runs, arch):
    """3 steps, ``save_checkpoint`` of the gathered tree, a restore into
    blocks and 3 more steps equal 6 uninterrupted steps bit for bit, with a
    gossip on each side of the checkpoint."""
    _, ranks = runs[0][arch]
    for res in ranks:
        for kind in ("p", "v"):
            a = _by(res, f"ckpt/a/{kind}/")
            assert a
            for path, value in a.items():
                np.testing.assert_array_equal(res[f"ckpt/b/{kind}/{path}"], value, err_msg=path)


def test_launcher_matches_direct_step(runs):
    """``launch.train pod --fed --pods 2 --device cpu`` under ``torchrun
    --nproc-per-node 4``: the reference's lines on rank 0 with the step's
    losses, driven directly on the launcher's weights, batches and
    pod-seeded wire generator; every rank's timing line (a gossip's bytes
    at the gossip step) and equal digests on a pod's ranks."""
    out = runs[1]
    direct = runs[0][LAUNCH_ARCH][1][0]["launch/losses"]
    lines = [line for line in out.splitlines() if not line.startswith("rank ")]
    assert lines[0] == (f"fed pod mode: {PODS} pods x data={DATA} ({DATA} ranks a pod) "
                        f"topology=ring every={EVERY} bits=8")
    printed = [float(re.search(r"loss=(\S+)", line).group(1)) for line in lines[1:1 + STEPS]]
    assert printed == [float(f"{x:.4f}") for x in direct]
    assert re.fullmatch(r"done \(inter-pod param spread=\d+\.\d{5}\)", lines[-1])
    assert float(lines[-1].split("=")[1].rstrip(")")) > 0
    timing = {int(r): json.loads(t) for r, t in re.findall(r"rank (\d+): timing (.*)", out)}
    digests = {int(r): d for r, d in re.findall(r"rank (\d+): digest=(\w+)", out)}
    assert sorted(timing) == sorted(digests) == list(range(WORLD))
    for r, t in timing.items():
        np.testing.assert_allclose(t["losses"], direct, rtol=1e-6, atol=0)
        assert t["pod"] == r // DATA and all(c["calls"] > 0 for c in t["data"])
        assert [c["bytes"] > 0 for c in t["gossip"]] == [s in GOSSIPS for s in range(STEPS)]
        assert digests[r] == digests[DATA * (r // DATA)]
    assert digests[0] != digests[DATA]
