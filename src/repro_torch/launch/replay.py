"""Trace-driven metal deployment launcher (the port of ``repro.launch.replay``).

Loads a recorded ``SimTrace`` (either package's ``launch/sim.py --record``:
they share the schema), rebuilds the recorded scenario from its header
provenance, and executes the schedule on live devices through
``repro_torch.sim.metal.MetalReplay``, on the card unless ``--device cpu``
is given:

  * default: one process; ``--host-devices N`` walks its chains on N
    positions of the process's device (the counterpart of XLA's virtual
    host devices);
  * ``--processes N``: spawns N local worker processes (fresh
    interpreters, importing this checkout's ``repro_torch``), each joining
    a gloo process group for the census (``launch/mesh.py
    make_metal_mesh``) and computing a contiguous chain slice;
    trajectories merge through a length-prefixed TCP all-gather
    (:class:`SocketExchange`, hub at rank 0). Every process runs the
    identical replicated finalize, and the final device matrices are
    digest-compared across ranks. On the card every worker opens its own
    CUDA context; N workers may share one card. The parent builds the
    kernels before it spawns, so the workers only load them.

``--check`` replays the trace through the port's simulator in-process and
holds the metal state to it: bit for bit where every window is 32-bit,
else within ``--tolerance-factor`` x the simulator's own spread under other
quantizer seed words (same initial weights). ``--fault-inject`` re-derives
the executed-step masks from the recorded churn/straggler timeline instead
of trusting them (``--stall-scale`` turns the deficit into real process
stalls). ``--obs`` writes a metal-side telemetry stream diffable against
the sim's: ``python tools/obs_diff.py sim_obs.jsonl metal_obs.jsonl``.
Each rank prints a ``timing`` JSON line: host ms a window (synchronized),
the exchange's ms and bytes, its peak memory and its kernel launches (its
own process, before the check).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.sim --scenario uniform_sync \\
      --device cpu --record trace.jsonl
  PYTHONPATH=src python -m repro_torch.launch.replay --trace trace.jsonl \\
      --check --device cpu
  PYTHONPATH=src python -m repro_torch.launch.replay --trace trace.jsonl \\
      --processes 2 --check --fault-inject --device cpu
  PYTHONPATH=src python -m repro_torch.launch.replay --trace trace.jsonl \\
      --host-devices 2 --obs metal_obs.jsonl
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import socket
import struct
import subprocess
import sys
import tempfile
import time


def _send_msg(sock: socket.socket, blob: bytes) -> None:
    sock.sendall(struct.pack("!Q", len(blob)) + blob)


def _recv_msg(sock: socket.socket) -> bytes:
    buf = b""
    while len(buf) < 8:
        chunk = sock.recv(8 - len(buf))
        if not chunk:
            raise ConnectionError("exchange peer closed mid-header")
        buf += chunk
    (n,) = struct.unpack("!Q", buf)
    out = bytearray()
    while len(out) < n:
        chunk = sock.recv(min(1 << 20, n - len(out)))
        if not chunk:
            raise ConnectionError("exchange peer closed mid-payload")
        out += chunk
    return bytes(out)


class SocketExchange:
    """All-gather over localhost TCP: rank 0 is the hub — it collects every
    shard's payload, assembles the rank-ordered list, and broadcasts it
    back. Payloads are pickled numpy arrays with an 8-byte length prefix.
    This is the deployment's *message plane*, deliberately separate from
    any collective: a DFedRW fleet exchanges models over a network (see
    ``repro_torch.sim.metal``). ``bytes_sent``/``bytes_received`` count
    this rank's traffic, length prefixes included."""

    def __init__(self, n_shards: int, shard_id: int, host: str, port: int,
                 timeout_s: float = 300.0):
        self.n_shards = int(n_shards)
        self.shard_id = int(shard_id)
        self.bytes_sent = 0
        self.bytes_received = 0
        self._conns: dict[int, socket.socket] = {}
        self._sock = None
        self._srv = None
        if self.shard_id == 0:
            self._srv = socket.create_server((host, port))
            self._srv.settimeout(timeout_s)
            for _ in range(self.n_shards - 1):
                conn, _ = self._srv.accept()
                conn.settimeout(timeout_s)
                (rank,) = struct.unpack("!Q", _recv_msg(conn))
                self._conns[rank] = conn
        else:
            deadline = time.monotonic() + timeout_s
            while True:
                try:
                    self._sock = socket.create_connection(
                        (host, port), timeout=timeout_s)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
            self._sock.settimeout(timeout_s)
            _send_msg(self._sock, struct.pack("!Q", self.shard_id))

    def _send(self, sock, blob: bytes) -> None:
        _send_msg(sock, blob)
        self.bytes_sent += 8 + len(blob)

    def _recv(self, sock) -> bytes:
        blob = _recv_msg(sock)
        self.bytes_received += 8 + len(blob)
        return blob

    def allgather(self, payload) -> list:
        if self.shard_id == 0:
            received = {0: payload}
            for rank, conn in self._conns.items():
                received[rank] = pickle.loads(self._recv(conn))
            out = [received[r] for r in range(self.n_shards)]
            blob = pickle.dumps(out, protocol=pickle.HIGHEST_PROTOCOL)
            for conn in self._conns.values():
                self._send(conn, blob)
            return out
        self._send(self._sock, pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL))
        return pickle.loads(self._recv(self._sock))

    def close(self) -> None:
        for conn in self._conns.values():
            conn.close()
        if self._srv is not None:
            self._srv.close()
        if self._sock is not None:
            self._sock.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _package_root() -> str:
    """The directory that holds this checkout's ``repro_torch``."""
    import repro_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))


def _spawn_workers(args: argparse.Namespace) -> int:
    """Parent path of ``--processes N``: build the kernels once (on the
    card), pick coordinator/exchange ports, spawn N workers of this CLI
    (rank 0 carries --check/--obs) with this checkout's package root first
    on their ``PYTHONPATH``, and fail, stopping the rest, if any worker
    fails. Each worker's standard output goes to a file of its own and is
    copied out in rank order once all have ended, so that no two workers'
    lines interleave; standard error is shared as it comes."""
    if args.device != "cpu":
        from repro_torch.device import resolve_device
        from repro_torch.kernels.quantize import quantize as qk

        resolve_device(args.device)      # no card: raise here, before any worker
        qk.build()
    coord_port, exch_port = _free_port(), _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_package_root()] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs, outs = [], [tempfile.TemporaryFile() for _ in range(args.processes)]
    for rank in range(args.processes):
        cmd = [sys.executable, "-m", "repro_torch.launch.replay",
               "--trace", args.trace,
               "--processes", str(args.processes),
               "--process-id", str(rank),
               "--coordinator", f"127.0.0.1:{coord_port}",
               "--exchange-port", str(exch_port),
               "--host-devices", str(args.host_devices),
               "--eval-every", str(args.eval_every),
               "--tolerance-factor", str(args.tolerance_factor),
               "--stall-scale", str(args.stall_scale),
               "--device", args.device]
        if args.fault_inject:
            cmd.append("--fault-inject")
        if rank == 0:
            if args.check:
                cmd.append("--check")
            if args.obs:
                cmd += ["--obs", args.obs]
        procs.append(subprocess.Popen(cmd, env=env, stdout=outs[rank]))
    rc = 0
    live = dict(enumerate(procs))
    while live:
        for rank, p in list(live.items()):
            code = p.poll()
            if code is None:
                continue
            del live[rank]
            if code != 0:
                print(f"worker {rank} exited with {code}", file=sys.stderr)
                rc = 1
                for other in live.values():
                    other.kill()
        time.sleep(0.05)
    for p, out in zip(procs, outs):
        p.wait()
        out.seek(0)
        sys.stdout.write(out.read().decode())
        out.close()
    sys.stdout.flush()
    return rc


def _peak_memory(device) -> dict:
    import resource

    import torch

    out = {"peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    if device.type == "cuda":
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trace", required=True,
                    help="recorded SimTrace JSONL (launch/sim.py --record)")
    ap.add_argument("--processes", type=int, default=1,
                    help="localhost deployment size; >1 spawns workers")
    ap.add_argument("--process-id", type=int, default=-1,
                    help="internal: this worker's rank (set by the parent)")
    ap.add_argument("--coordinator", default="",
                    help="gloo census coordinator host:port (workers)")
    ap.add_argument("--exchange-port", type=int, default=0,
                    help="internal: trajectory-exchange hub port (workers)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="walk each process's chains on this many positions "
                         "of its device (0 = one)")
    ap.add_argument("--check", action="store_true",
                    help="replay through the simulator in-process and hold "
                         "the metal trajectory to it (bit for bit at fp32, "
                         "quantization tolerance below 32 bits)")
    ap.add_argument("--tolerance-factor", type=float, default=4.0,
                    help="bits<32 tolerance: allowed metal deviation as a "
                         "multiple of the simulator's own spread under other "
                         "seed words")
    ap.add_argument("--fault-inject", action="store_true",
                    help="re-derive exec masks / dead aggregators from the "
                         "recorded churn+straggler timeline and verify the "
                         "live degradation matches the sim's")
    ap.add_argument("--stall-scale", type=float, default=0.0,
                    help="with --fault-inject: real seconds slept per "
                         "recorded missing step (0 = derive only)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="eval cadence (0 = the trace header's)")
    ap.add_argument("--obs", default="",
                    help="write the metal-side repro_torch.obs stream here "
                         "(diff vs the sim stream with tools/obs_diff.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every process: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.processes > 1 and args.process_id < 0:
        return _spawn_workers(args)

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.dfedrw import DFedRW
    from repro_torch.device import resolve_device
    from repro_torch.kernels.quantize import quantize as qk
    from repro_torch.launch.mesh import make_metal_mesh
    from repro_torch.sim import (CHAIN_SLICE_TOL, FaultInjector, MetalReplay, SimTrace,
                                 build_scenario, conformance_diff, smallest_block)

    device = resolve_device(args.device)
    trace = SimTrace.load(args.trace)
    h = trace.header
    if not {"scenario", "build_seed", "key_seed"} <= set(h):
        raise SystemExit(
            "trace header lacks launcher provenance (scenario/build_seed/"
            "key_seed): record it via `python -m repro_torch.launch.sim --record`")
    setup = build_scenario(h["scenario"], n=h["n"], seed=h["build_seed"],
                           **dict(h.get("build_overrides", {})))

    rank = max(args.process_id, 0)
    # this worker's chain slice sizes its positions (contiguous split,
    # same arithmetic as MetalReplay._shard_slice)
    m_local = len(np.array_split(np.arange(h["m_chains"]),
                                 max(args.processes, 1))[rank])
    positions, info = make_metal_mesh(
        chains=m_local, device=[device] * max(args.host_devices, 1),
        coordinator=args.coordinator or None,
        num_processes=args.processes if args.processes > 1 else 1,
        process_id=rank)
    exchange = None
    if args.processes > 1:
        exchange = SocketExchange(args.processes, rank, "127.0.0.1",
                                  args.exchange_port)
    print(f"metal[{rank}]: trace={args.trace} scenario={h['scenario']} "
          f"n={h['n']} windows={len(trace.windows)} bits={h['bits']} "
          f"processes={info['process_count']} device={device} "
          f"devices local={info['local_devices']} "
          f"global={info['global_devices']} mesh_axis={info['mesh_axis']}", flush=True)

    engine = DFedRW(setup.model, setup.data, setup.topo, setup.cfg, device=device)
    metal = MetalReplay(engine, exchange=exchange, devices=positions)
    rec = None
    if args.obs:
        from repro_torch.obs import Recorder, VirtualClock
        rec = Recorder(clock=VirtualClock())
        metal.attach_obs(rec)
    fault = (FaultInjector(policy=h["policy"], stall_scale=args.stall_scale)
             if args.fault_inject else None)
    eval_every = args.eval_every or max(h.get("eval_every", 1), 1)
    result = metal.run(trace, torch.Generator().manual_seed(h["key_seed"]),
                       setup.x_test, setup.y_test, eval_every=eval_every, fault=fault)
    final = result.history.final()
    print(f"metal[{rank}]: done acc={final['accuracy']:.4f} "
          f"best={final['best_accuracy']:.4f} "
          f"virtual_time={result.virtual_time_s:.1f}s")
    if fault is not None:
        print(f"metal[{rank}]: faults verified — stalls={fault.stalls_injected} "
              f"steps_stalled={fault.steps_stalled} "
              f"aggregators_dropped={fault.aggregators_dropped}")
    timing = {key: [t[key] for t in metal.timings]
              for key in ("window_ms", "exchange_ms", "exchange_bytes")}
    if exchange is not None:
        timing.update(bytes_sent=exchange.bytes_sent, bytes_received=exchange.bytes_received)
    timing.update(positions=metal.positions_used, launches=dict(qk.LAUNCHES),
                  **_peak_memory(device))
    print(f"metal[{rank}]: timing {json.dumps(timing)}", flush=True)

    digest = hashlib.sha256(
        np.ascontiguousarray(result.device_matrix).tobytes()).hexdigest()
    rc = 0
    if exchange is not None:
        digests = exchange.allgather(digest)
        exchange.close()
        dist.destroy_process_group()
        if len(set(digests)) != 1:
            print(f"metal[{rank}]: SHARD DIVERGENCE {digests}", file=sys.stderr)
            return 1
        print(f"metal[{rank}]: shards agree digest={digest[:16]}")
    else:
        print(f"metal[{rank}]: digest={digest[:16]}")

    if args.check:
        runner = setup.runner(device=device)
        sim_res = runner.replay(trace, torch.Generator().manual_seed(h["key_seed"]),
                                setup.x_test, setup.y_test, eval_every=eval_every)
        diff = conformance_diff(sim_res, result)
        quantized = any((w.bits if w.bits is not None else h["bits"]) < 32
                        for w in trace.windows)
        block = smallest_block(h["m_chains"], max(args.processes, 1),
                               max(args.host_devices, 1))
        if not quantized and block > 1:
            tol, basis = 0.0, "bit-exact (fp32)"
        elif not quantized:
            tol = (CHAIN_SLICE_TOL["atol"]
                   + CHAIN_SLICE_TOL["rtol"] * float(np.abs(result.device_matrix).max()))
            basis = ("fp32, a position walks one chain: atol {atol} + rtol {rtol} x "
                     "max|w|".format(**CHAIN_SLICE_TOL))
        else:
            # the same initial weights as the sim's, other seed words: the
            # spread of the stochastic quantizer alone
            params = setup.model.init(torch.Generator().manual_seed(h["key_seed"]),
                                      runner.engine.device)
            alt = setup.runner(device=device).replay(
                trace, torch.Generator().manual_seed(h["key_seed"] + 104729),
                setup.x_test, setup.y_test, eval_every=eval_every, params=params)
            spread = conformance_diff(sim_res, alt)
            tol = args.tolerance_factor * spread
            basis = (f"{args.tolerance_factor}x other-seed-words sim spread "
                     f"{spread:.3e}")
        ok = diff <= tol
        print(f"conformance: max_abs_diff={diff:.3e} tolerance={tol:.3e} "
              f"({basis}) -> {'OK' if ok else 'FAIL'}")
        rc = 0 if ok else 1
    if rec is not None:
        from repro_torch.obs import provenance
        rec.save(args.obs, provenance=provenance(config=vars(args), device=device),
                 workload="metal", scenario=h["scenario"])
        print(f"obs: wrote {args.obs} (diff vs sim: "
              f"python tools/obs_diff.py <sim_obs> {args.obs})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
