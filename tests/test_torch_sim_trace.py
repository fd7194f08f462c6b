"""Recorded simulator traces across the two packages, on the CPU.

Contracts:
- a trace recorded by the JAX simulator replays through the port with the
  JAX run's seed words and initial params: records exactly equal, params
  within the flat engine's contract (tests/_torch_sim_pair.py);
- a trace recorded by the port loads in ``repro.sim.SimTrace`` and the JAX
  replay of it is bit-identical to the JAX run;
- the port's replay of its own trace is bit-identical to its run;
- a header that does not match the engine raises ``TraceIntegrityError``;
- ``python -m repro_torch.launch.sim --device cpu --rounds 2`` runs, and
  ``--record`` then ``--replay`` print the same final line.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.sim as jsim
from _torch_sim_pair import RECORD_FIELDS, assert_params_close, assert_same_value, run_pair

from repro_torch.launch.sim import main
from repro_torch.sim import SimTrace, TraceIntegrityError, build_scenario
from _torch_threads import torch_threads  # noqa: F401

CASES = {"straggler_bits8": ("straggler_tail", {"bits": 8}),
         "overlap_async": ("overlap_async", {}),
         "adaptive_uplink": ("adaptive_uplink", {})}


def _same_records(a, b):
    assert len(a.records) == len(b.records)
    for i, (ra, rb) in enumerate(zip(a.records, b.records)):
        for f in RECORD_FIELDS + ("host_loop_s",):
            assert_same_value(getattr(ra, f), getattr(rb, f), (i, f))


@pytest.mark.parametrize("case", sorted(CASES))
def test_traces_replay_across_packages(case, tmp_path):
    scenario, ov = CASES[case]
    out = run_pair(scenario, 3, **ov)
    jres, tres = out["jres"], out["tres"]
    # JAX-recorded trace -> the port's replay
    tr = out["tsetup"].runner(device="cpu")
    rep = tr.replay(jres.trace, torch.Generator().manual_seed(0), out["tsetup"].x_test,
                    out["tsetup"].y_test, eval_every=1, qseeds=out["qseeds"],
                    params=out["tparams"])
    _same_records(jres, rep)
    assert rep.history.comm_bits == jres.history.comm_bits
    assert_params_close(jres, rep, quantized=min(r.bits for r in rep.records) < 32)
    # port-recorded trace -> the JAX package's SimTrace and replay
    path = tmp_path / "port.jsonl"
    tres.trace.save(str(path))
    loaded = jsim.SimTrace.load(str(path))
    jr = out["jsetup"].runner()
    jrep = jr.replay(loaded, out["root"], out["jsetup"].x_test, out["jsetup"].y_test,
                     eval_every=1)
    np.testing.assert_array_equal(np.asarray(jrep.state.device_params),
                                  np.asarray(jres.state.device_params))
    assert jrep.history.train_loss == jres.history.train_loss


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_replay_is_bit_identical(case, tmp_path):
    scenario, ov = CASES[case]
    setup = build_scenario(scenario, n=12, seed=1, **ov)
    res = setup.runner(device="cpu").run(3, torch.Generator().manual_seed(5),
                                         setup.x_test, setup.y_test, eval_every=1,
                                         record=True)
    path = tmp_path / "t.jsonl"
    res.trace.save(str(path))
    rep = setup.runner(device="cpu").replay(SimTrace.load(str(path)),
                                            torch.Generator().manual_seed(5),
                                            setup.x_test, setup.y_test, eval_every=1)
    assert torch.equal(res.state.device_params, rep.state.device_params)
    _same_records(res, rep)
    assert dataclasses.asdict(res.history) == dataclasses.asdict(rep.history)
    assert res.final() == rep.final()


def test_replay_refuses_a_mismatched_header():
    setup = build_scenario("straggler_tail", n=12, seed=0)
    res = setup.runner(device="cpu").run(1, torch.Generator().manual_seed(0), record=True)
    other = build_scenario("straggler_tail", n=12, seed=0, bits=8).runner(device="cpu")
    with pytest.raises(TraceIntegrityError, match="bits"):
        other.replay(res.trace, torch.Generator().manual_seed(0))
    bad = SimTrace(header=dict(res.trace.header), windows=list(res.trace.windows) * 2)
    with pytest.raises(TraceIntegrityError, match="sequential"):
        setup.runner(device="cpu").replay(bad, torch.Generator().manual_seed(0))


def test_cli_record_replay_same_final_line(tmp_path, capsys):
    path = str(tmp_path / "cli.jsonl")
    main(["--scenario", "straggler_tail", "--device", "cpu", "--rounds", "2",
          "--n", "12", "--bits", "8", "--record", path])
    run_out = capsys.readouterr().out
    main(["--replay", path, "--device", "cpu"])
    rep_out = capsys.readouterr().out
    final = [ln for ln in run_out.splitlines() if ln.startswith("final:")]
    assert final and final == [ln for ln in rep_out.splitlines()
                               if ln.startswith("final:")]
    with pytest.raises(SystemExit):
        main(["--replay", path, "--record", path, "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--trace", "--device", "cpu"])
    main(["--list"])
    assert "fleet_metro" in capsys.readouterr().out
