"""The group placement of the port's gossip against its stacked placement,
on the CPU: four ``torch.distributed`` processes over gloo (``file://``
init, one thread each), one pod a rank.

Each rank (``_WORKER``) builds the same four-pod tree (the mamba2-130m
SMOKE model drawn from a seeded generator, each pod scaled by its own
seeded perturbation) and keeps its own pod. The uniforms of wire tensor
(leaf, offset, pod) are drawn from a generator seeded by the three, so both
placements quantize with the same ones. Rank 0 then runs the stacked
placement of the same calls in the same process.

Contracts: bit for bit, ``gossip_mix`` at bits 32 and 8 on the ring (two
offsets) and the complete graph (offset 2 sends to the rank it receives
from), ``walk_permute_batch``, and two steps of ``make_fed_train_step`` at
bits 8 (parameters, velocities and the mean loss); ``make_pod_mesh(2)``
over the four ranks gives each rank its (pod, data) coordinates and its
two groups, and three pods over four ranks raise ValueError.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from _torch_threads import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 4
MIXES = [("ring", 32), ("ring", 8), ("all", 8)]

_WORKER = textwrap.dedent("""
    import os, sys
    rank, world, init, out, src = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                   sys.argv[4], sys.argv[5])
    sys.path.insert(0, src)
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.dist import GossipConfig, gossip_mix, make_fed_train_step, walk_permute_batch
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import momentum_init

    MIXES = %(mixes)r
    cpu = torch.device("cpu")
    cfg = get_smoke("mamba2-130m")
    base = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = [leaf.shape for leaf in tree_leaves(base)]

    def pods_tree():
        def scale(leaf, p, li):
            g = torch.Generator().manual_seed(100 * li + p)
            return leaf * (1 + 0.05 * torch.randn(leaf.shape, generator=g))
        leaves = iter(range(10 ** 6))
        def conv(node):
            if isinstance(node, dict):
                return {k: conv(node[k]) for k in sorted(node)}
            li = next(leaves)
            return torch.stack([scale(node, p, li) for p in range(world)])
        return conv(base)

    def uniforms_of(salt):
        def uniforms(li, oi, pod):
            g = torch.Generator().manual_seed(salt * 10 ** 6 + 1000 * li + 100 * oi + pod)
            return torch.rand(shapes[li], generator=g)
        return uniforms

    def mine(tree, i):
        if isinstance(tree, dict):
            return {k: mine(v, i) for k, v in tree.items()}
        return tree[i].clone()

    def batches(steps):
        rng = np.random.default_rng(0)
        out = []
        for _ in range(steps):
            toks = rng.integers(0, cfg.vocab, size=(world, 2, 33))
            out.append({"tokens": torch.as_tensor(toks[..., :-1]),
                        "labels": torch.as_tensor(toks[..., 1:])})
        return out

    def fed(mesh, params, pick):
        step_fn, _, _ = make_fed_train_step(cfg, mesh, GossipConfig(quant_bits=8), lr_r=20.0,
                                            remat=False)
        vel = momentum_init(params).velocity
        losses = []
        for step, batch in enumerate(batches(2)):
            params, vel, loss = step_fn(params, vel, pick(batch), step,
                                        uniforms=uniforms_of(step + 1))
            losses.append(float(loss))
        return params, vel, losses

    def save(name, results):
        arrays = {}
        for key, value in results.items():
            if isinstance(value, dict):
                for li, leaf in enumerate(tree_leaves(value)):
                    arrays[f"{key}/{li}"] = leaf.numpy()
            else:
                arrays[key] = np.asarray(value)
        np.savez(os.path.join(out, name), **arrays)

    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    try:
        group = dist.group.WORLD
        stacked = pods_tree()
        results = {}
        for topo, bits in MIXES:
            results[f"mix_{topo}_{bits}"] = gossip_mix(
                mine(stacked, rank), GossipConfig(topology=topo, quant_bits=bits), group=group,
                uniforms=uniforms_of(0))
        results["walk"] = walk_permute_batch(mine(stacked, rank), group, 1)
        mesh = make_pod_mesh(0, device=cpu, group=group)
        params, vel, losses = fed(mesh, T.init_params(cfg, torch.Generator().manual_seed(0),
                                                      device="cpu"),
                                  lambda b: {k: v[rank] for k, v in b.items()})
        results.update(fed_params=params, fed_vel=vel, fed_losses=np.array(losses))
        pm = make_pod_mesh(2, device=cpu, group=group)
        me = torch.tensor([float(rank)])
        results["pod_mesh"] = np.array([pm.pod, pm.host.data_axis.rank, pm.pods, pm.data])
        results["pod_gather"] = pm.pod_axis.all_gather(me, 0).numpy()
        results["data_gather"] = pm.host.data_axis.all_gather(me, 0).numpy()
        try:
            make_pod_mesh(3, device=cpu, group=group)
            results["three"] = np.array("no error")
        except ValueError as err:
            results["three"] = np.array(f"ValueError: {err}")
        save(f"group{rank}.npz", results)
        dist.barrier()
    finally:
        dist.destroy_process_group()

    if rank == 0:                 # the stacked placement of the same calls
        results = {}
        for topo, bits in MIXES:
            results[f"mix_{topo}_{bits}"] = gossip_mix(
                stacked, GossipConfig(topology=topo, quant_bits=bits), uniforms=uniforms_of(0))
        results["walk"] = walk_permute_batch(stacked, world, 1)
        from repro_torch.convert import stack_pods
        params, vel, losses = fed(make_pod_mesh(world, device=cpu),
                                  stack_pods(T.init_params(cfg, torch.Generator().manual_seed(0),
                                                           device="cpu"), world, "cpu"),
                                  lambda b: b)
        results.update(fed_params=params, fed_vel=vel, fed_losses=np.array(losses))
        save("stacked.npz", results)
""" % {"mixes": MIXES})


@pytest.fixture(scope="module")
def placements(tmp_path_factory):
    out = tmp_path_factory.mktemp("group")
    init = str(out / "init")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), str(WORLD), init,
                               str(out), os.path.join(ROOT, "src")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(WORLD)]
    errors = []
    for rank, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        if proc.returncode != 0:
            errors.append(f"rank {rank}: {err[-2000:]}")
    assert not errors, "\n".join(errors)
    group = [dict(np.load(out / f"group{rank}.npz")) for rank in range(WORLD)]
    return group, dict(np.load(out / "stacked.npz"))


def _leaf_keys(results, prefix):
    return sorted((k for k in results if k.startswith(prefix + "/")),
                  key=lambda k: int(k.rsplit("/", 1)[1]))


@pytest.mark.parametrize("topology,bits", MIXES)
def test_group_gossip_equals_stacked(placements, topology, bits):
    group, stacked = placements
    keys = _leaf_keys(stacked, f"mix_{topology}_{bits}")
    assert len(keys) == 11
    for key in keys:
        got = np.stack([g[key] for g in group])
        np.testing.assert_array_equal(got, stacked[key], err_msg=key)
    assert any(not np.array_equal(stacked[k][0], stacked[k][1]) for k in keys)


def test_group_walk_hand_off_equals_stacked(placements):
    group, stacked = placements
    for key in _leaf_keys(stacked, "walk"):
        np.testing.assert_array_equal(np.stack([g[key] for g in group]), stacked[key])


def test_group_fed_steps_equal_stacked(placements):
    group, stacked = placements
    for g in group:
        np.testing.assert_array_equal(g["fed_losses"], stacked["fed_losses"])
    for prefix in ("fed_params", "fed_vel"):
        keys = _leaf_keys(stacked, prefix)
        assert len(keys) == 11
        for key in keys:
            np.testing.assert_array_equal(np.stack([g[key] for g in group]), stacked[key],
                                          err_msg=key)
    # The pods trained on their own batches and were mixed: they differ.
    first = stacked[_leaf_keys(stacked, "fed_params")[0]]
    assert not np.array_equal(first[0], first[1])


def test_pods_with_a_data_axis_raise(placements):
    """``make_pod_mesh(2)`` over four ranks is the reference's ``(2, 2, 1)``
    mesh: rank r at pod r // 2 and data index r % 2, its gossip group the
    ranks with its data index in pod order, its pod's data group the pod's
    two ranks; three pods over four ranks raise ValueError."""
    group, _ = placements
    for r, g in enumerate(group):
        assert g["pod_mesh"].tolist() == [r // 2, r % 2, 2, 2]
        assert g["pod_gather"].tolist() == [float(r % 2), float(r % 2 + 2)]
        assert g["data_gather"].tolist() == [float(r - r % 2), float(r - r % 2 + 1)]
        assert str(g["three"]).startswith("ValueError") and "divide" in str(g["three"])
