"""The port's telemetry (repro_torch.obs) against the JAX package's
(repro.obs) on the CPU.

Contracts:
- the same ``Recorder`` calls give the same JSONL lines in both packages,
  header provenance aside, and the same Prometheus text;
- ``repro.obs.ObsStream`` loads a stream the port wrote;
- on one scenario, the port's simulator stream has the JAX simulator's
  counter totals and virtual-time span totals, and ``tools/obs_diff.py``
  exits 0 on the pair;
- the heap and the fleet engine write byte-identical ``tspan`` lines (and
  equal to the JAX simulator's).
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

import repro.obs as jobs
from _torch_sim_pair import run_pair

import repro_torch.obs as tobs
from repro_torch.sim import build_scenario
from _torch_threads import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _drive(obs_mod, t):
    clock = obs_mod.VirtualClock(lambda: t[0])
    rec = obs_mod.Recorder(clock=clock, trace=True)
    for i in range(300):
        t[0] = 0.5 * i
        rec.counter("engine/rounds")
        rec.counter("engine/comm_bits", 1.5e6 + i, bits=8 if i % 3 else 4)
        rec.gauge("sim/bits", float(8 - i % 2))
        rec.histogram("sim/window_steps", np.arange(i % 7))
        rec.histogram("lat", 0.01 * i)
        rec.record_span("sim/window", t[0], t[0] + 0.25)
        with rec.span("engine/plan"):
            t[0] += 0.125
        rec.duration("sim/uplink_busy", 0.03 * i, t=t[0])
        rec.trace_span("sgd", trace=f"c{i}", span=f"c{i}.s0", parent=f"c{i}.h0",
                       t0=t[0], t1=t[0] + 1.0, win=i, dev=np.int64(i % 5))
        if i % 10 == 0:
            rec.flush()
    rec.note_trace_coarse()
    return rec


def test_same_calls_same_lines(tmp_path):
    jrec, trec = _drive(jobs, [0.0]), _drive(tobs, [0.0])
    jl, tl = jrec.to_stream().to_lines(), trec.to_stream().to_lines()
    assert jl == tl
    assert jrec.to_prometheus() == trec.to_prometheus()
    # the port's stream, with its provenance, loads in the JAX package
    path = str(tmp_path / "port.jsonl")
    trec.save(path, provenance=tobs.provenance(config={"a": 1}, device="cpu"),
              workload="sim")
    loaded = jobs.ObsStream.load(path)
    assert loaded.header["schema"] == "repro.obs"
    assert loaded.header["version"] == jobs.OBS_SCHEMA_VERSION
    prov = loaded.header["provenance"]
    assert set(tobs.PROVENANCE_KEYS) <= set(prov) and prov["backend"] == "cpu"
    assert [json.dumps(e) for e in loaded.events] == tl[1:-1]


def test_sim_stream_matches_jax_and_obs_diff_passes(tmp_path):
    jrec = jobs.Recorder(clock=jobs.VirtualClock(), trace=True)
    trec = tobs.Recorder(clock=tobs.VirtualClock(), trace=True)
    run_pair("congested_uplink", 3, bits=8, obs=(jrec, trec))
    js, ts = jrec.to_stream(), trec.to_stream()
    jsum, tsum = js.summary, ts.summary
    assert jsum["counters"] == tsum["counters"]
    assert jsum["spans"] == tsum["spans"]
    assert jsum["hists"] == tsum["hists"]
    # tspans (causal trees in virtual seconds) are identical too
    jt = [json.dumps(e) for e in js.events if e["kind"] == "tspan"]
    tt = [json.dumps(e) for e in ts.events if e["kind"] == "tspan"]
    assert jt and jt == tt
    paths = [str(tmp_path / f) for f in ("jax.jsonl", "port.jsonl")]
    jrec.save(paths[0], provenance=jobs.provenance(), workload="sim")
    trec.save(paths[1], provenance=tobs.provenance(device="cpu"), workload="sim")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "obs_diff.py"),
                           *paths], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_heap_and_fleet_tspans_byte_identical():
    lines = []
    for engine in ("heap", "fleet"):
        setup = build_scenario("fleet_metro", n=20, seed=0)
        runner = setup.runner(engine=engine, device="cpu")
        rec = tobs.Recorder(clock=tobs.VirtualClock(), trace=True)
        runner.attach_obs(rec, trace=True)
        res = runner.run(2, torch.Generator().manual_seed(0), setup.x_test, setup.y_test,
                         eval_every=2)
        lines.append(([json.dumps(e) for e in rec.events if e["kind"] == "tspan"],
                      res.final()))
    (heap, hfin), (fleet, ffin) = lines
    assert heap and heap == fleet
    hfin.pop("events_per_sec"), ffin.pop("events_per_sec")
    assert hfin == ffin
