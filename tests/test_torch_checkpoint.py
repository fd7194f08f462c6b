"""The port's checkpoint store (repro_torch.checkpoint) against the JAX
package's (repro.checkpoint) on the CPU.

Contracts: a round trip is bit-identical, with the template's dtypes and
devices; ``latest_step`` finds the newest step; a template of another
shape is refused; the file format is the reference's, so a file written
by either package loads bit-identically in the other; and the launcher's
``--checkpoint-dir`` writes a file the JAX ``load_checkpoint`` reads.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.checkpoint import load_checkpoint as j_load, save_checkpoint as j_save
from repro.models import make_lstm_lm as j_make_lstm

import torch

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.flatten import tree_leaves
from repro_torch.models import make_lstm_lm
from _torch_threads import torch_threads  # noqa: F401

SMALL = dict(vocab=200, embed=32, hidden=64, layers=2)


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return torch.zeros_like(tree)


def test_round_trip_is_bit_identical(tmp_path):
    params = make_lstm_lm(**SMALL).init(torch.Generator().manual_seed(0), "cpu")
    tree = {"params": params, "step_count": torch.tensor(7, dtype=torch.int64),
            "acc": np.array([0.5, 0.75])}
    path = save_checkpoint(str(tmp_path), 3, tree, metrics={"loss": 1.5})
    assert path.endswith("step_00000003.npz")
    template = {"params": _zeros_like(params), "step_count": torch.tensor(0),
                "acc": np.zeros(2)}
    back, meta = load_checkpoint(str(tmp_path), template)
    assert meta == {"step": 3, "metrics": {"loss": 1.5}}
    assert isinstance(back["params"]["cells"], list)
    assert isinstance(back["params"]["cells"][0], tuple)
    for a, b in zip(tree_leaves(tree["params"]), tree_leaves(back["params"])):
        assert b.dtype == a.dtype and torch.equal(a, b)
    assert back["step_count"].dtype == torch.int64 and int(back["step_count"]) == 7
    np.testing.assert_array_equal(back["acc"], tree["acc"])
    # the template's dtype wins
    half = load_checkpoint(str(tmp_path), {**template, "acc": np.zeros(2, np.float32)})[0]
    assert half["acc"].dtype == np.float32


def test_latest_step(tmp_path):
    assert latest_step(str(tmp_path / "missing")) is None
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), {"w": torch.zeros(2)})
    for step in (5, 120, 17):
        save_checkpoint(str(tmp_path), step, {"w": torch.full((2,), float(step))})
    (tmp_path / "step_00000999.npz.tmp").write_bytes(b"")     # a write never renamed
    assert latest_step(str(tmp_path)) == 120
    back, meta = load_checkpoint(str(tmp_path), {"w": torch.zeros(2)})
    assert meta["step"] == 120 and back["w"].tolist() == [120.0, 120.0]
    back, _ = load_checkpoint(str(tmp_path), {"w": torch.zeros(2)}, step=17)
    assert back["w"].tolist() == [17.0, 17.0]


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path), {"w": torch.zeros(4, 3)})
    with pytest.raises(KeyError, match="v"):
        load_checkpoint(str(tmp_path), {"v": torch.zeros(3, 4)})


def test_jax_file_loads_in_the_port(tmp_path):
    jp = j_make_lstm(**SMALL).init(jax.random.PRNGKey(1))
    j_save(str(tmp_path), 4, {"params": jp, "round": jnp.int32(4)}, metrics={"acc": 0.25})
    template = {"params": _zeros_like(lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")),
        "round": torch.tensor(0, dtype=torch.int32)}
    back, meta = load_checkpoint(str(tmp_path), template)
    assert meta == {"step": 4, "metrics": {"acc": 0.25}}
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(back["params"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(back["round"]) == 4


def test_port_file_loads_in_jax(tmp_path):
    tp = make_lstm_lm(**SMALL).init(torch.Generator().manual_seed(2), "cpu")
    save_checkpoint(str(tmp_path), 9, tp, metrics={"acc": 0.5})
    template = jax.eval_shape(j_make_lstm(**SMALL).init, jax.random.PRNGKey(0))
    back, meta = j_load(str(tmp_path), template)
    assert meta == {"step": 9, "metrics": {"acc": 0.5}}
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_launcher_checkpoint_loads_in_jax(tmp_path, capsys):
    from repro_torch.launch.train import main

    ckpt = str(tmp_path / "ckpt")
    main(["protocol", "--algo", "dfedavg", "--bits", "8", "--device", "cpu",
          "--rounds", "2", "--devices", "6", "--epochs", "2", "--checkpoint-dir", ckpt])
    out = capsys.readouterr().out
    assert f"checkpointed to {ckpt}" in out
    back, meta = j_load(ckpt, {"history_acc": np.zeros(2)})
    assert meta["step"] == 2
    acc = back["history_acc"]
    assert acc.shape == (2,) and np.all((acc >= 0) & (acc <= 1))
