"""The port's substrate against the JAX package's: the numpy copies (graph,
walk, heterogeneity, synthetic data) give identical arrays from identical
seeds; the flat codec lays params out exactly as the reference does and
round-trips; the last-writer election breaks ties as the reference does;
the step-size schedule and the Lemma-1 estimate agree."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import graph as j_graph
from repro.core import heterogeneity as j_het
from repro.core import walk as j_walk
from repro.core.dfedrw import gamma_hat_from_traj as j_gamma_hat
from repro.core.flatten import flatten_tree as j_flatten
from repro.core.flatten import make_flat_spec as j_make_spec
from repro.core.flatten import masked_scatter_last_wins as j_scatter
from repro.data import FederatedDataset as JData
from repro.data import synthetic_image_classification as j_synth
from repro.models import make_fnn as j_make_fnn
from repro.optim import decreasing_lr as j_lr

from repro_torch.convert import params_from_numpy
from repro_torch.core import graph, heterogeneity, walk
from repro_torch.core.dfedrw import gamma_hat_from_traj
from repro_torch.core.flatten import (
    LANES,
    elect_writers,
    flatten_tree,
    make_flat_spec,
    masked_scatter_last_wins,
    tree_leaves,
    unflatten_tree,
)
from repro_torch.data import FederatedDataset, synthetic_image_classification
from repro_torch.optim import decreasing_lr
from _torch_threads import torch_threads  # noqa: F401

TOPOLOGIES = ["complete", "ring", "expander3", "expander5", "star", "erdos_renyi"]


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_topology_identical(name):
    jt, tt = j_graph.make_topology(name, 12), graph.make_topology(name, 12)
    np.testing.assert_array_equal(jt.adjacency, tt.adjacency)
    np.testing.assert_array_equal(jt.transition, tt.transition)
    assert jt.lambda_p == tt.lambda_p
    for i in (0, 5, 11):
        np.testing.assert_array_equal(jt.neighbors(i, include_self=True),
                                      tt.neighbors(i, include_self=True))
    np.testing.assert_array_equal(
        j_graph.metropolis_hastings_matrix(jt.adjacency, lazy=0.0),
        graph.metropolis_hastings_matrix(tt.adjacency, lazy=0.0))


@pytest.mark.parametrize("straggler", [None, dict(h_percent=40, mode="truncate"),
                                       dict(h_percent=40, mode="partial")])
@pytest.mark.parametrize("name", ["complete", "ring", "expander3"])
def test_sample_walks_identical(name, straggler):
    jt, tt = j_graph.make_topology(name, 15), graph.make_topology(name, 15)
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    js = j_walk.StragglerModel(**straggler) if straggler else None
    ts = walk.StragglerModel(**straggler) if straggler else None
    for _ in range(3):
        jp = j_walk.sample_walks(jt, 6, 5, jrng, straggler=js)
        tp = walk.sample_walks(tt, 6, 5, trng, straggler=ts)
        np.testing.assert_array_equal(jp.devices, tp.devices)
        np.testing.assert_array_equal(jp.mask, tp.mask)
        np.testing.assert_array_equal(jp.k_m, tp.k_m)
        np.testing.assert_array_equal(jp.last_device, tp.last_device)


@pytest.mark.parametrize("kind", ["similarity", "dirichlet", "nonbalance"])
def test_partitions_identical(kind):
    x, y = j_synth(n_samples=1200, seed=4)
    tx, ty = synthetic_image_classification(n_samples=1200, seed=4)
    np.testing.assert_array_equal(x, tx)
    np.testing.assert_array_equal(y, ty)
    call = {
        "similarity": lambda m, lab: m.partition_similarity(lab, 10, 30, np.random.default_rng(7)),
        "dirichlet": lambda m, lab: m.partition_dirichlet(lab, 10, 0.5, np.random.default_rng(7)),
        "nonbalance": lambda m, lab: m.partition_nonbalance(lab, 10, np.random.default_rng(7),
                                                            max_per_label=40),
    }[kind]
    jp, tp = call(j_het, y), call(heterogeneity, ty)
    for a, b in zip(jp.client_indices, tp.client_indices):
        np.testing.assert_array_equal(a, b)
    jd, td = JData.from_partition(x, y, jp), FederatedDataset.from_partition(tx, ty, tp)
    np.testing.assert_array_equal(jd.client_idx, td.client_idx)
    np.testing.assert_array_equal(jd.client_sizes, td.client_sizes)


def test_flat_codec_matches_reference_and_round_trips():
    jmodel = j_make_fnn((17, 5), in_dim=33, out_dim=7)
    params = jmodel.init(jax.random.PRNGKey(3))
    jspec = j_make_spec(params)
    tparams = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in params],
                                device="cpu")
    spec = make_flat_spec(tparams)
    assert (spec.shapes, spec.sizes, spec.padded_sizes, spec.offsets, spec.d, spec.d_pad) == (
        jspec.shapes, jspec.sizes, jspec.padded_sizes, jspec.offsets, jspec.d, jspec.d_pad)
    assert spec.d_pad % LANES == 0 and spec.rows * LANES == spec.d_pad
    np.testing.assert_array_equal(flatten_tree(tparams, spec).numpy(),
                                  np.asarray(j_flatten(params, jspec)))
    # batched round trip restores the nesting and every leaf
    rng = np.random.default_rng(0)
    stacked = [tuple(torch.from_numpy(rng.normal(size=(6, *t.shape)).astype(np.float32))
                     for t in pair) for pair in tparams]
    flat = flatten_tree(stacked, spec)
    assert flat.shape == (6, spec.d_pad)
    back = unflatten_tree(flat, spec)
    assert isinstance(back, list) and all(isinstance(p, tuple) and len(p) == 2 for p in back)
    for a, b in zip(tree_leaves(stacked), tree_leaves(back)):
        assert torch.equal(a, b)
    # padding lanes are zero
    live = np.zeros(spec.d_pad, bool)
    for off, size in zip(spec.offsets, spec.sizes):
        live[off:off + size] = True
    assert (flat[:, ~live] == 0).all()


@pytest.mark.parametrize("case", range(60))
def test_election_matches_reference_tie_breaking(case):
    """The cases of tests/test_flat_engine.py:166: random collision patterns
    (several writers on one row, all inactive, heavy duplication). The
    election and the scatter equal the reference's and the sequential loop."""
    rng = np.random.default_rng(case)
    n = int(rng.integers(2, 13))
    m = int(rng.integers(1, 17))
    buf = rng.normal(size=(n, 4)).astype(np.float32)
    idx = rng.integers(0, n, size=m).astype(np.int32)
    mask = rng.random(m) < 0.6
    vals = rng.normal(size=(m, 4)).astype(np.float32)

    expect = buf.copy()
    for c in range(m):
        if mask[c]:
            expect[idx[c]] = vals[c]
    jout = np.asarray(j_scatter(jnp.asarray(buf), jnp.asarray(idx), jnp.asarray(mask),
                                jnp.asarray(vals)))
    out = masked_scatter_last_wins(torch.from_numpy(buf), torch.from_numpy(idx),
                                   torch.from_numpy(mask), torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(out, expect)
    np.testing.assert_array_equal(out, jout)

    from repro.core.flatten import elect_writers as j_elect
    jw, jwins = j_elect(jnp.asarray(idx), jnp.asarray(mask), n)
    tw, twins = elect_writers(torch.from_numpy(idx), torch.from_numpy(mask), n)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(twins.numpy(), np.asarray(jwins))


@pytest.mark.parametrize("kbar", [0, 1, 2, 7, 100, 12345])
def test_decreasing_lr_matches(kbar):
    np.testing.assert_allclose(decreasing_lr(kbar, 5.0, 0.499),
                               float(j_lr(kbar, 5.0, 0.499)), rtol=1e-6)


def test_gamma_hat_matches_reference():
    grad_sq = np.array([[1.0, 400.0], [4.0, 400.0], [9.0, 400.0]], np.float32)
    rng = np.random.default_rng(0)
    masks = [np.array([[True] * 3, [False] * 3]), np.ones((2, 3), bool),
             rng.random((2, 3)) < 0.5, np.zeros((2, 3), bool)]
    for mask in masks:
        want = float(j_gamma_hat(jnp.asarray(grad_sq), jnp.asarray(mask)))
        got = float(gamma_hat_from_traj(torch.from_numpy(grad_sq), torch.from_numpy(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
