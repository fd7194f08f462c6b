"""The port's renderers (repro_torch.obs.report, repro_torch.obs.critical)
and ``launch/train.py protocol --obs/--trace`` against the JAX package's, on
the CPU.

Contracts:
- ``render_report`` and ``render_prometheus`` of the port, on a golden
  stream read by the port's ``ObsStream``, give text equal byte for byte to
  the JAX package's on the same file read by its own ``ObsStream``;
- ``critical_paths``, ``straggler_table`` and ``render_critical`` are equal
  to the JAX package's on a traced ``fleet_metro`` stream that the port's
  simulator wrote (n = 20, 2 windows, on the CPU), for both engines;
- ``train protocol --obs --trace --device cpu`` writes a stream that the
  JAX package's ``ObsStream`` reads and its ``render_report`` renders, with
  the same final line as the run without ``--obs``; ``--trace`` without
  ``--obs`` and ``--obs`` with a baseline exit as the reference does.
"""
import contextlib
import dataclasses
import io
import os

import pytest
import torch

import repro.obs as jobs
from repro.launch.train import main as j_train

import repro_torch.obs as tobs
from repro_torch.launch.train import main as t_train
from repro_torch.sim import build_scenario
from _torch_threads import torch_threads  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
STREAMS = ["obs_traced.jsonl", "obs_base.jsonl", "obs_regressed.jsonl"]


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("renderer", ["render_report", "render_prometheus"])
def test_golden_renders_match_jax(name, renderer):
    path = os.path.join(GOLDEN, name)
    mine = getattr(tobs, renderer)(tobs.ObsStream.load(path))
    ref = getattr(jobs, renderer)(jobs.ObsStream.load(path))
    assert mine and mine == ref


def test_split_key_matches_jax():
    from repro.obs.report import split_key as j_split

    from repro_torch.obs.report import split_key

    for key in ('engine/comm_bits{bits="8"}', "engine/rounds",
                'serve/ttft{arch="a",mode="b"}', "odd{"):
        assert split_key(key) == j_split(key)


@pytest.fixture(scope="module")
def fleet_streams(tmp_path_factory):
    """Traced fleet_metro streams (n = 20, 2 windows) the port wrote, one an
    engine."""
    paths = {}
    for engine in ("heap", "fleet"):
        setup = build_scenario("fleet_metro", n=20, seed=0)
        runner = setup.runner(engine=engine, device="cpu")
        rec = tobs.Recorder(clock=tobs.VirtualClock(), trace=True)
        runner.attach_obs(rec, trace=True)
        runner.run(2, torch.Generator().manual_seed(0), setup.x_test, setup.y_test,
                   eval_every=2)
        paths[engine] = str(tmp_path_factory.mktemp(engine) / "fleet.jsonl")
        rec.save(paths[engine], provenance=tobs.provenance(device="cpu"),
                 workload="sim", scenario="fleet_metro")
    return paths


@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_critical_path_matches_jax_on_a_port_stream(fleet_streams, engine):
    mine_stream = tobs.ObsStream.load(fleet_streams[engine])
    ref_stream = jobs.ObsStream.load(fleet_streams[engine])
    mine, ref = tobs.critical_paths(mine_stream), jobs.critical_paths(ref_stream)
    assert len(mine) == 2
    assert [dataclasses.asdict(p) for p in mine] == [dataclasses.asdict(p) for p in ref]
    assert tobs.straggler_table(mine) == jobs.straggler_table(ref)
    text = tobs.render_critical(mine_stream)
    assert text == jobs.render_critical(ref_stream)
    assert text[0].startswith("critical path") and any(
        line.startswith("straggler league") for line in text)
    # The whole report: byte for byte but for the provenance line, whose
    # keys are each package's own.
    mine_lines = tobs.render_report(mine_stream).splitlines()
    ref_lines = jobs.render_report(ref_stream).splitlines()
    assert [line for line in mine_lines if not line.startswith("provenance:")] == \
        [line for line in ref_lines if not line.startswith("provenance:")]


def _final(run, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(argv)
    return [line for line in buf.getvalue().splitlines() if line.startswith("final:")], \
        buf.getvalue()


def test_train_obs_trace_stream_reads_in_jax(tmp_path):
    path = str(tmp_path / "train.jsonl")
    argv = ["protocol", "--rounds", "2", "--bits", "8", "--devices", "8",
            "--device", "cpu"]
    plain, _ = _final(t_train, argv)
    traced, out = _final(t_train, argv + ["--obs", path, "--trace"])
    assert plain and plain == traced
    assert f"obs: wrote {path}" in out
    stream = jobs.ObsStream.load(path)
    assert stream.header["trace"] is True and stream.header["workload"] == "train"
    assert stream.header["algo"] == "dfedrw"
    assert stream.header["provenance"]["backend"] == "cpu"
    assert stream.summary["counters"]["engine/rounds"] == 2
    ref = jobs.render_report(stream)
    mine = tobs.render_report(tobs.ObsStream.load(path))
    assert "communication by wire width" in ref and "engine/execute_round" in ref
    assert [line for line in mine.splitlines() if not line.startswith("provenance:")] == \
        [line for line in ref.splitlines() if not line.startswith("provenance:")]


@pytest.mark.parametrize("extra", [["--trace"], ["--algo", "fedavg", "--obs", "unused.jsonl"]],
                         ids=["trace-without-obs", "baseline-with-obs"])
def test_train_obs_refusals_match_jax(extra, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["protocol", "--rounds", "1", "--devices", "4"] + extra
    with pytest.raises(SystemExit) as ref:
        j_train(argv)
    with pytest.raises(SystemExit) as mine:
        t_train(argv + ["--device", "cpu"])
    assert str(mine.value) == str(ref.value) and "--" in str(ref.value)
    assert not os.path.exists("unused.jsonl")
