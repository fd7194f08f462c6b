"""The port's metal deployment launcher (``repro_torch.launch.replay``) on the
CPU, at n = 12 and two windows.

Contracts:
- ``SocketExchange.allgather`` gives every rank the same rank-ordered list,
  round after round, and counts its bytes;
- ``--trace T --check --device cpu`` holds the metal run to the port's
  simulator: bit for bit at bits 32, within the tolerance at bits 8;
- ``--processes 2 --check --fault-inject --device cpu`` spawns two workers
  that exchange trajectories over TCP, verify the faults and print equal
  digests;
- a trace recorded by the JAX package's ``repro.launch.sim --record``
  replays through the port's launcher;
- without ``--device cpu`` and without a card the launcher raises: there
  is no CPU fallback.
"""
import json
import os
import re
import subprocess
import sys
import threading

import pytest
import torch

from repro_torch.launch.replay import SocketExchange, _free_port, main
from repro_torch.launch.sim import main as sim_main
from _torch_threads import torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _record(path, scenario="uniform_sync", bits=32, seed=0):
    sim_main(["--scenario", scenario, "--n", "12", "--rounds", "2", "--seed", str(seed),
              "--eval-every", "2", "--bits", str(bits), "--device", "cpu", "--record", path])


def test_socket_exchange_allgather_round():
    port = _free_port()
    out, traffic = {}, {}

    def run_rank(rank):
        ex = SocketExchange(2, rank, "127.0.0.1", port, timeout_s=30.0)
        for _ in range(2):                       # two rounds over one link
            out[rank] = ex.allgather({"rank": rank})
        traffic[rank] = (ex.bytes_sent, ex.bytes_received)
        ex.close()

    t = threading.Thread(target=run_rank, args=(1,))
    t.start()
    run_rank(0)
    t.join(timeout=30.0)
    assert not t.is_alive()
    assert out[0] == out[1] == [{"rank": 0}, {"rank": 1}]
    assert traffic[0][0] == traffic[1][1] > 0 and traffic[0][1] == traffic[1][0] > 0


@pytest.mark.parametrize("bits", [32, 8])
def test_cli_check_single_process(bits, tmp_path, capsys):
    trace = str(tmp_path / "trace.jsonl")
    _record(trace, bits=bits)
    capsys.readouterr()
    assert main(["--trace", trace, "--check", "--device", "cpu", "--host-devices", "2"]) == 0
    out = capsys.readouterr().out
    assert "conformance: max_abs_diff=0.000e+00" in out and "-> OK" in out
    assert ("bit-exact (fp32)" in out) == (bits == 32)
    timing = json.loads(re.search(r"metal\[0\]: timing (.*)", out).group(1))
    assert len(timing["window_ms"]) == 2 and timing["exchange_bytes"] == [0, 0]


def test_cli_two_process_deployment_with_faults(tmp_path):
    trace = str(tmp_path / "trace.jsonl")
    _record(trace, scenario="churn_dropout", seed=2)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.replay", "--trace", trace,
         "--processes", "2", "--check", "--fault-inject", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr[-3000:]
    digests = re.findall(r"metal\[(\d)\]: shards agree digest=(\w+)", out)
    assert sorted(r for r, _ in digests) == ["0", "1"], out
    assert len({d for _, d in digests}) == 1, out
    assert out.count("faults verified") == 2
    assert "bit-exact (fp32)" in out and "-> OK" in out
    for rank in (0, 1):
        timing = json.loads(re.search(rf"metal\[{rank}\]: timing (.*)", out).group(1))
        assert min(timing["exchange_bytes"]) > 0 and timing["bytes_sent"] > 0


def test_cli_replays_a_trace_recorded_by_the_jax_package(tmp_path, capsys):
    from repro.launch.sim import main as jax_sim_main

    trace = str(tmp_path / "jax_trace.jsonl")
    jax_sim_main(["--scenario", "straggler_tail", "--n", "12", "--rounds", "2",
                  "--eval-every", "2", "--record", trace])
    capsys.readouterr()
    assert main(["--trace", trace, "--check", "--fault-inject", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "scenario=straggler_tail" in out and "faults verified" in out
    assert "bit-exact (fp32)" in out and "-> OK" in out


def test_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA default is valid here")
    trace = str(tmp_path / "trace.jsonl")
    _record(trace)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--trace", trace])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--trace", trace, "--processes", "2"])
