"""DFedRW and QDFedRW protocol engine (paper Alg. 1 / Alg. 2) in PyTorch.

The port of the flat-buffer engine of ``repro.core.dfedrw``
(``DFedRW._build_round_fn_flat``). The n federated client models live as
ONE ``(n, d_pad)`` float32 matrix on the device (repro_torch.core.flatten),
and one communication round runs, in the reference's order:

  1. *Walk planning* (host, numpy): M Metropolis-Hastings chains with
     straggler-dependent lengths K_m, and one ``rng.integers`` draw for the
     (M, K, B) batch indices. Line for line the reference's planner, so one
     ``cfg.seed`` gives the same plans and the same Eq. 18 bits.
  2. *Chain SGD* (Eq. 10): the M chain models are M rows; each of the K
     steps is one batched per-chain gradient, a masked step with the
     globally decreasing step size eta^kbar and, for QDFedRW, the Eq. 13 hop
     hand-off ``chain + deq(Q(stepped - chain))`` as ONE fused kernel call
     (repro_torch.kernels.quantize).
  3. *w^{t,last} scatter*: one winner election replays the sequential
     (step, chain) write order; one row copy writes the winners.
  4. *Aggregation* (Eq. 11 / Eq. 14): fp32 gathers and averages the
     neighbor rows; QDFedRW quantizes each updated device's message once
     (one kernel call) and lands it on every aggregator listing the sender
     with one matrix product.

Everything that depends only on the plan (winner election, scatter indices)
is computed on the host and sent to the device once per round. Step 2 is
``_walk`` and steps 3-4 are ``_finalize``; the metal replay
(repro_torch.sim.metal) runs the walk on slices of the chains and the
finalize on the gathered trajectory, the same code on the same rows.

The virtual-time simulator (repro_torch.sim) drives the same round through
three seams: ``plan_walks(state, topo=, m=)``, ``plan_aggregation(plan,
topo=)`` (with the CSR branch for an implicit ``SparseTopology``) and
``execute_round(..., account_plan=, bits=)``; ``attach_obs`` records the
reference's ``engine/*`` spans and counters.

``chain_mode=True`` is the paper's large-scale LM mode (§VI-F, the LSTM):
the M chains persist across rounds (each starts where it ended) and the
chain-end devices aggregate the M chain-end models.

``DFedRWConfig.engine`` selects the implementation, as in the reference:
``"flat"`` (the default, above) or ``"reference"``, the port of the seed
per-leaf engine (``DFedRW._build_round_fn_reference``), kept as the
numerical oracle and the benchmark's baseline. Its device state is the
model's tree with every leaf stacked ``(n, ...)``; it steps the chains on
the stacked tree, quantizes each leaf as its own wire tensor with the plain
``core.quantization`` oracle (never a hand-written kernel, on the CPU or on
the card: the reference's seed engine calls the ``jnp`` quantizer, not
Pallas), writes the chains into ``w^{t,last}`` one at a time in chain order
and aggregates leaf by leaf. Both engines share the host planner, so seeded
runs are comparable round by round; at bits 32 they give the same device
parameters bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.flatten import (
    FlatSpec,
    elect_writers,
    flatten_tree,
    make_flat_spec,
    tree_from_leaves,
    tree_leaves,
    tree_map,
    unflatten_tree,
)
from repro_torch.core.graph import Topology
from repro_torch.core.quantization import (
    QuantConfig,
    dequantize,
    quantize,
    quantize_rows,
    validate_wire_bits,
    wire_bits,
)
from repro_torch.core.walk import StragglerModel, WalkPlan, sample_walks
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.kernels.quantize import payload_quantize_dequantize
from repro_torch.models.fnn import SmallModel
from repro_torch.optim.sgd import decreasing_lr

__all__ = ["DFedRWConfig", "DFedRWState", "DFedRW", "FlatRunner", "RoundMetrics",
           "gamma_hat_from_traj"]


@dataclasses.dataclass(frozen=True)
class DFedRWConfig:
    m_chains: int = 5
    k_walk: int = 5
    agg_fraction: float = 0.25      # fraction of devices aggregating per round
    n_agg: int = 5                  # |N_A(i)| cap
    batch_size: int = 50
    lr_r: float = 5.0
    lr_q: float = 0.499
    quant: QuantConfig = dataclasses.field(default_factory=lambda: QuantConfig(bits=32))
    straggler: StragglerModel = dataclasses.field(default_factory=StragglerModel)
    chain_mode: bool = False        # large-scale LM mode (§VI-F): aggregate the
                                    # M chain-end models; chains persist across rounds
    engine: str = "flat"            # "flat" (vectorized + kernels) | "reference"
    seed: int = 0


@dataclasses.dataclass
class DFedRWState:
    device_params: Any              # flat engine: (n, d_pad) float32 matrix;
                                    # reference engine: tree, leaves (n, ...)
    round: int = 0
    global_step: int = 0            # kbar counter
    chain_starts: np.ndarray | None = None  # chain mode: i_m^{t,0}
    comm_bits_total: float = 0.0
    comm_bits_busiest: float = 0.0
    updated: np.ndarray | None = None  # (n,) bool: device has trained/aggregated


@dataclasses.dataclass
class RoundMetrics:
    round: int
    train_loss: float
    comm_bits_round: float
    comm_bits_busiest_round: float
    gamma_hat: float


def gamma_hat_from_traj(grad_sq_traj: torch.Tensor, walk_mask: torch.Tensor) -> torch.Tensor:
    """Lemma-1 estimate ||g_last|| / ||g_first|| averaged over chains.

    ``grad_sq_traj`` (K, M) squared gradient norms, ``walk_mask`` (M, K).
    The first/last *active* step of each chain brackets the ratio; chains
    whose mask is entirely False performed no step and are excluded."""
    m, k = walk_mask.shape
    mask = walk_mask.to(torch.int64)
    active_steps = mask.sum(dim=1)                                 # (M,)
    k_first = torch.argmax(mask, dim=1)                            # 0 if none
    k_last = k - 1 - torch.argmax(mask.flip(1), dim=1)
    chains = torch.arange(m, device=grad_sq_traj.device)
    g0 = torch.sqrt(grad_sq_traj[k_first, chains] + 1e-12)
    g_last = torch.sqrt(grad_sq_traj[k_last, chains] + 1e-12)
    alive = active_steps > 0
    ratios = torch.where(alive, g_last / g0, torch.zeros_like(g0))
    return ratios.sum() / torch.clamp(alive.sum(), min=1)


def _sum_neighbors(t: torch.Tensor) -> torch.Tensor:
    """The sum over dim 1 of ``t`` (A, n_agg, ...), added in neighbor order:
    the order a torch sum over that dim takes for the flat engine's wide
    rows, which it leaves for another on a narrow leaf (a 10-wide bias)."""
    out = t[:, 0]
    for j in range(1, t.shape[1]):
        out = out + t[:, j]
    return out


class FlatRunner:
    """What every runner on the flat buffer shares (DFedRW here, the
    baselines in repro_torch.core.baselines): the model, dataset, topology,
    config and protocol rng bound to one device, the dataset resident
    there; the flat codec; per-row gradients and losses; evaluation."""

    def __init__(self, model: SmallModel, data: FederatedDataset, topo: Topology, cfg,
                 device: str | torch.device = "cuda"):
        if data.n_clients != topo.n:
            raise ValueError("dataset clients must match graph size")
        validate_wire_bits(cfg.quant.bits)
        self.device = resolve_device(device)
        self.model = model
        self.data = data
        self.topo = topo
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # The dataset stays resident on the device; batches are gathers.
        self._x = torch.as_tensor(data.x, device=self.device)
        self._y = torch.as_tensor(data.y, device=self.device)
        self.flat_spec: FlatSpec = make_flat_spec(
            model.init(torch.Generator().manual_seed(0), "cpu"))

        def loss_flat(vec, xb, yb):
            return model.loss_fn(unflatten_tree(vec, self.flat_spec), (xb, yb))

        # Per-row gradients of the chain (or selected device) rows:
        # vmap(grad) as in the reference, which torch lowers to batched
        # matrix products.
        self._grad_fn = torch.func.vmap(torch.func.grad(loss_flat))
        self._loss_fn = torch.func.vmap(loss_flat)

    def _replicated(self, params) -> torch.Tensor:
        """The (n, d_pad) device matrix with every row the model tree
        ``params``."""
        vec = flatten_tree(params, self.flat_spec).to(self.device)
        return vec[None, :].repeat(self.topo.n, 1)

    def state_from_params(self, params) -> DFedRWState:
        """Every device starts from the same ``params`` (the model's tree)."""
        return DFedRWState(device_params=self._replicated(params),
                           updated=np.zeros(self.topo.n, dtype=bool))

    def init_state(self, key: torch.Generator) -> DFedRWState:
        return self.state_from_params(self.model.init(key, self.device))

    def _mean_model(self, state: DFedRWState, sel: torch.Tensor):
        """The model tree averaged over the devices ``sel``."""
        return unflatten_tree(state.device_params[sel].mean(dim=0), self.flat_spec)

    @torch.no_grad()
    def evaluate(self, state: DFedRWState, x_test, y_test, max_batch: int = 2048) -> dict:
        """Accuracy/loss of the average over *participating* device models
        (devices that never trained/aggregated still hold their init)."""
        if state.updated is not None and state.updated.any():
            sel = torch.from_numpy(np.nonzero(state.updated)[0]).to(self.device)
        else:
            sel = torch.arange(self.topo.n, device=self.device)
        mean_params = self._mean_model(state, sel)
        x_test = torch.as_tensor(np.asarray(x_test[:max_batch]), device=self.device)
        y_test = torch.as_tensor(np.asarray(y_test[:max_batch]), device=self.device)
        logits = self.model.predict(mean_params, x_test)
        acc = (logits.argmax(-1) == y_test).to(torch.float32).mean()
        loss = self.model.loss_fn(mean_params, (x_test, y_test))
        return {"accuracy": float(acc), "loss": float(loss)}


class DFedRW(FlatRunner):
    """Runner binding (model, dataset, topology, config) to one device."""

    def __init__(
        self,
        model: SmallModel,
        data: FederatedDataset,
        topo: Topology,
        cfg: DFedRWConfig,
        device: str | torch.device = "cuda",
    ):
        if cfg.engine not in ("flat", "reference"):
            raise ValueError(f"unknown engine {cfg.engine!r}: 'flat' or 'reference'")
        super().__init__(model, data, topo, cfg, device)

        def loss_tree(params, xb, yb):
            return model.loss_fn(params, (xb, yb))

        # The seed engine's per-chain gradients and losses on the stacked
        # tree: the same batched products as the flat engine's on its rows.
        self._tree_grad_fn = torch.func.vmap(torch.func.grad(loss_tree))
        self._tree_loss_fn = torch.func.vmap(loss_tree)
        self.obs = None             # optional repro_torch.obs.Recorder (attach_obs)
        self._prepared: set[int] = {validate_wire_bits(cfg.quant.bits)}
        self._programs_run: set[int] = set()

    # ------------------------------------------------------- per-width table
    # The reference keeps one compiled round program per wire width. The
    # port runs eagerly and compiles nothing per width, so it has no trace or
    # retrace count to report; it keeps the table's meaning: ``prepare_bits``
    # validates up front every width a bits controller may ask for (a width
    # outside it raises before any round runs), ``prepared_bits`` lists them,
    # and ``programs_run`` is the set of widths whose rounds actually ran.
    def prepare_bits(self, widths) -> None:
        """Validate every wire width an adaptive bits-policy may request."""
        for b in widths:
            self._prepared.add(validate_wire_bits(int(b)))

    @property
    def prepared_bits(self) -> tuple[int, ...]:
        return tuple(sorted(self._prepared))

    @property
    def programs_run(self) -> tuple[int, ...]:
        """Distinct wire widths whose rounds have executed."""
        return tuple(sorted(self._programs_run))

    def attach_obs(self, rec) -> None:
        """Attach a ``repro_torch.obs.Recorder``. Instrumentation is host-side
        Python at round boundaries only, so attaching a recorder changes no
        rng stream and no output bit."""
        self.obs = rec

    # ------------------------------------------------------------------ init
    def state_from_params(self, params) -> DFedRWState:
        """Every device starts from the same ``params`` (the model's tree).
        In chain mode the M chain starts are drawn from the protocol rng
        here, before any planning, as the reference's ``init_state`` does."""
        starts = None
        if self.cfg.chain_mode:
            starts = self.rng.integers(0, self.topo.n, size=self.cfg.m_chains)
        if self.cfg.engine == "flat":
            device_params = self._replicated(params)
        else:
            n = self.topo.n
            device_params = tree_map(
                lambda p: p.to(self.device).expand(n, *p.shape).clone(), params)
        return DFedRWState(device_params=device_params, chain_starts=starts,
                           updated=np.zeros(self.topo.n, dtype=bool))

    def params_pytree(self, state: DFedRWState) -> Any:
        """The stacked per-device model tree, leaves (n, ...), whichever the
        engine."""
        if self.cfg.engine == "flat":
            return unflatten_tree(state.device_params, self.flat_spec)
        return state.device_params

    def _mean_model(self, state: DFedRWState, sel: torch.Tensor):
        if self.cfg.engine == "flat":
            return super()._mean_model(state, sel)
        return tree_map(lambda p: p[sel].mean(dim=0), state.device_params)

    # ------------------------------------------------------------ the round
    def _round_flat(self, device_flat, plan, bidx, agg, kbar0, bits, qseeds):
        """One round of the flat engine (reference ``dfedrw.py:261-393``):
        the walk over every chain, then the finalize. Returns (new device
        matrix, mean loss, gamma_hat) as device tensors."""
        dev = self.device
        walk_mask = torch.from_numpy(plan.mask.copy()).to(device=dev)
        bidx_t = torch.from_numpy(np.ascontiguousarray(bidx.swapaxes(0, 1))).to(device=dev)
        chain_ids = torch.from_numpy(plan.devices[:, 0].astype(np.int64)).to(device=dev)
        xb_all = self._x[bidx_t]                              # (K, M, B, ...)
        yb_all = self._y[bidx_t]
        traj, grad_sq = self._walk(device_flat[chain_ids], walk_mask, xb_all, yb_all,
                                   kbar0, bits, qseeds)
        return self._finalize(device_flat, traj, grad_sq, plan.devices, plan.mask, agg,
                              (xb_all[-1], yb_all[-1]), bits,
                              None if qseeds is None else qseeds[-1])

    def _walk(self, chain, walk_mask, xb_all, yb_all, kbar0, bits, hop_seeds):
        """The K-step chain SGD loop (Eq. 10) from the chain starts ``chain``
        (m, d_pad), on the tensors' own device: masked steps at the globally
        decreasing step size and, at bits < 32, the Eq. 13 hand-off, one hop
        kernel call a step salted by ``hop_seeds[step]``. ``walk_mask`` is
        (m, K) and ``xb_all``/``yb_all`` (K, m, B, ...). Every row reads only
        its own chain. Returns the (K, m, d_pad) trajectory and the (K, m)
        squared gradient norms."""
        cfg, spec = self.cfg, self.flat_spec
        traj, grad_sq = [], []
        for step in range(walk_mask.shape[1]):
            lr = decreasing_lr(kbar0 + step + 1, cfg.lr_r, cfg.lr_q)
            grads = self._grad_fn(chain, xb_all[step], yb_all[step])   # (m, d_pad)
            stepped = torch.where(walk_mask[:, step, None], chain - lr * grads, chain)
            if bits < 32:
                # Eq. 13: the hand-off transmits Q(w^{k+1} - w^k), one wire
                # tensor per leaf; the receiver's w^k + deq(Q(diff)) is fused
                # into the same kernel pass.
                stepped = payload_quantize_dequantize(
                    stepped - chain, spec, per_message=False, bits=bits,
                    s=cfg.quant.s, seed=hop_seeds[step], base=chain)
            traj.append(stepped)
            grad_sq.append(torch.sum(grads * grads, dim=1))
            chain = stepped
        return torch.stack(traj), torch.stack(grad_sq)

    def _finalize(self, device_flat, traj, grad_sq, devices, mask, agg, last_batch, bits,
                  agg_seed):
        """The round's second half over the whole (K, M, d_pad) trajectory:
        the w^{t,last} scatter, the Eq. 11 or Eq. 14 aggregation (one
        payload kernel call salted by ``agg_seed`` at bits < 32),
        ``gamma_hat`` and the mean loss of the final chain models on
        ``last_batch``. ``devices`` and ``mask`` are the (M, K) plan on the
        host. Returns (new device matrix, mean loss, gamma_hat)."""
        cfg, spec, dev = self.cfg, self.flat_spec, self.device
        n_dev = device_flat.shape[0]
        m, k = devices.shape

        # Plan-only work on the host: the last-writer election over the
        # step-major trajectory and the valid aggregators (torch has no
        # dropping scatter, so losers and padded ids >= n are filtered out).
        devs_flat = torch.from_numpy(devices.T.reshape(-1).astype(np.int64))
        mask_flat = torch.from_numpy(mask.T.reshape(-1).copy())
        _, wins = elect_writers(devs_flat, mask_flat, n_dev)
        win_slots = torch.nonzero(wins).reshape(-1)
        agg_devices, agg_rows, agg_w = agg
        valid = np.nonzero(agg_devices < n_dev)[0]
        # Everything the finalize indexes with goes to the device up front.
        to = dict(device=dev)
        walk_mask = torch.from_numpy(mask.copy()).to(**to)
        devs_dev = devs_flat.to(**to)
        wins_dev = wins.to(**to)
        win_slots_dev = win_slots.to(**to)
        win_devs_dev = devs_flat[win_slots].to(**to)
        agg_dev_ids = torch.from_numpy(agg_devices[valid].astype(np.int64)).to(**to)
        rows_dev = torch.from_numpy(agg_rows[valid].astype(np.int64)).to(**to)
        w_dev = torch.from_numpy(agg_w[valid]).to(**to)

        traj2 = traj.reshape(k * m, spec.d_pad)               # step-major
        dev_last = device_flat.index_copy(0, win_devs_dev, traj2[win_slots_dev])
        gamma_hat = gamma_hat_from_traj(grad_sq, walk_mask)

        if bits < 32:
            # Eq. 14 payload: one message Q(w_l^{t,last} - w_l) per
            # walk-updated device; the aggregator weight matrix lands each
            # message on every aggregator listing the sender.
            base_rows = device_flat[devs_dev]                 # (K*M, d_pad)
            diffs = torch.where(wins_dev[:, None], traj2 - base_rows, 0.0)
            deq = payload_quantize_dequantize(
                diffs, spec, per_message=True, bits=bits, s=cfg.quant.s,
                seed=agg_seed)
            hits = rows_dev[:, :, None] == devs_dev[None, None, :]
            w3 = (w_dev[:, :, None] * hits).sum(dim=1) * wins_dev[None, :]
            upd = w3 @ deq                                    # (A, d_pad)
            new_rows = device_flat[agg_dev_ids] + upd
        else:
            gathered = dev_last[rows_dev]                     # (A, n_agg, d_pad)
            new_rows = torch.sum(w_dev[..., None] * gathered, dim=1)
        new_device_flat = dev_last.index_copy_(0, agg_dev_ids, new_rows)

        # Mean train loss over the round's final chain models, on their last
        # batch (cheap monitoring signal).
        losses = self._loss_fn(traj[-1], *last_batch)
        return new_device_flat, losses.mean(), gamma_hat

    # ----------------------------------------------- reference (seed) engine
    def _round_reference(self, device_params, plan, bidx, agg, kbar0, bits, uniforms,
                         generator):
        """One round of the seed engine (reference ``dfedrw.py:396-541``),
        leaf by leaf on the stacked tree, with the plain Eq. 12 quantizer.
        The uniforms of bits < 32 are ``uniforms["hop"][step][leaf]``, of
        shape (M, *leaf), and ``uniforms["agg"][leaf]``, of shape
        (A * n_agg, *leaf), or are drawn from ``generator`` in that order.
        Returns (new device tree, mean loss, gamma_hat) as device tensors."""
        cfg, dev = self.cfg, self.device
        qcfg = dataclasses.replace(cfg.quant, bits=bits)
        m, k = plan.devices.shape
        n_dev = self.topo.n

        def draw(given, shape):
            """The given uniforms, or a draw from the generator."""
            if given is not None:
                return given
            return torch.rand(shape, generator=generator, device=dev)

        walk_mask = torch.from_numpy(plan.mask.copy()).to(device=dev)
        bidx_t = torch.from_numpy(np.ascontiguousarray(bidx.swapaxes(0, 1))).to(device=dev)
        chain_ids = torch.from_numpy(plan.devices[:, 0].astype(np.int64)).to(device=dev)
        xb_all = self._x[bidx_t]                              # (K, M, B, ...)
        yb_all = self._y[bidx_t]
        start = tree_leaves(device_params)
        chain = tree_map(lambda p: p[chain_ids], device_params)   # w_{i^{t,0}}
        dev_last = [p.clone() for p in start]                 # w_l^{t,last}
        grad_sq = []
        for step in range(k):
            lr = decreasing_lr(kbar0 + step + 1, cfg.lr_r, cfg.lr_q)
            grads = tree_leaves(self._tree_grad_fn(chain, xb_all[step], yb_all[step]))
            old = tree_leaves(chain)
            # Straggler mask: inactive chains keep their params.
            stepped = [torch.where(walk_mask[:, step].reshape((m,) + (1,) * (c.dim() - 1)),
                                   c - lr * g, c) for c, g in zip(old, grads)]
            if bits < 32:
                # Eq. 13: the hand-off transmits Q(w^{k+1} - w^k), one wire
                # tensor a leaf spanning all M chains; the received model is
                # w^k + deq(Q(diff)). A step's uniforms are drawn even when
                # every chain is masked, as the reference's scan draws them.
                hop = [None] * len(old) if uniforms is None else uniforms["hop"][step]
                stepped = [o + dequantize(quantize(s - o, qcfg, draw(u, s.shape)),
                                          dtype=s.dtype)
                           for s, o, u in zip(stepped, old, hop)]
            # Each active chain's params go to its current device's
            # w^{t,last} slot, in chain order: the last chain to visit wins.
            for c in range(m):
                if plan.mask[c, step]:
                    d = int(plan.devices[c, step])
                    for buf, leaf in zip(dev_last, stepped):
                        buf[d] = leaf[c]
            grad_sq.append(sum(torch.sum(g * g, dim=tuple(range(1, g.dim()))) for g in grads))
            chain = tree_from_leaves(self.flat_spec, stepped)
        gamma_hat = gamma_hat_from_traj(torch.stack(grad_sq), walk_mask)

        # Decentralized aggregation (Eq. 11 / Eq. 14), leaf by leaf; padded
        # aggregator ids (>= n) are dropped before the write.
        agg_devices, agg_rows, agg_w = agg
        valid = torch.from_numpy(np.nonzero(agg_devices < n_dev)[0]).to(device=dev)
        agg_ids = torch.from_numpy(agg_devices.astype(np.int64)).to(device=dev)[valid]
        rows = torch.from_numpy(agg_rows.astype(np.int64)).to(device=dev)   # (A, n_agg)
        w = torch.from_numpy(agg_w).to(device=dev)
        new_leaves = []
        for li, (buf, base) in enumerate(zip(dev_last, start)):
            wl = w.reshape(w.shape + (1,) * (buf.dim() - 1))
            if bits < 32:
                # Eq. 14: each (aggregator, neighbor) message row quantized
                # on its own: one wire tensor a row, its own norm and s.
                diffs = buf[rows] - base[rows]                # (A, n_agg, ...)
                flat = diffs.reshape((-1,) + diffs.shape[2:])
                u = draw(None if uniforms is None else uniforms["agg"][li], flat.shape)
                qd = dequantize(quantize_rows(flat, qcfg, u)).reshape(diffs.shape)
                new_rows = base[agg_ids] + _sum_neighbors(wl * qd)[valid]
            else:
                new_rows = _sum_neighbors(wl * buf[rows])[valid]
            new_leaves.append(buf.index_copy_(0, agg_ids, new_rows))
        new_params = tree_from_leaves(self.flat_spec, new_leaves)

        # Mean train loss over the round's final chain models, on their last
        # batch (cheap monitoring signal).
        losses = self._tree_loss_fn(chain, xb_all[-1], yb_all[-1])
        return new_params, losses.mean(), gamma_hat

    # ------------------------------------------------------------- host side
    def _plan_round(self, state: DFedRWState) -> tuple[WalkPlan, np.ndarray, tuple]:
        plan, bidx = self.plan_walks(state)
        agg = self.plan_aggregation(plan)
        return plan, bidx, agg

    def plan_walks(
        self, state: DFedRWState, topo: Topology | None = None,
        m: int | None = None,
    ) -> tuple[WalkPlan, np.ndarray]:
        """Sample the round's M walk trajectories plus their per-step batch
        indices (one protocol-rng draw order shared by every engine and by
        the virtual-time simulator — repro_torch.sim truncates the returned plan
        before building the aggregation plan). ``topo`` overrides the bound
        topology (time-varying graphs); ``m`` overrides the chain count —
        the fully-asynchronous simulator samples fresh chains only into the
        slots freed at the last trigger, so a partially-busy window plans
        fewer than ``cfg.m_chains`` walks (m=None keeps the config count and
        the draw order the synchronous engine uses)."""
        cfg, rng = self.cfg, self.rng
        topo = self.topo if topo is None else topo
        m_chains = cfg.m_chains if m is None else int(m)
        if m is not None and cfg.chain_mode:
            raise ValueError("chain_mode chains persist by construction; "
                             "partial refills are undefined")
        plan = sample_walks(
            topo,
            m_chains,
            cfg.k_walk,
            rng,
            straggler=cfg.straggler,
            start_devices=state.chain_starts if cfg.chain_mode else None,
        )
        # Per-step batches from the visited device's local data. A slow device
        # contributes a *partial* update (paper Table II row 4): it processes
        # only batch_size/slowdown distinct samples within the global clock
        # (realized by tiling a sub-batch, i.e. an unbiased smaller-batch
        # gradient at unchanged shapes). One rng draw for the whole (M*K, B)
        # column tensor; the dense (n, max_size) client index matrix turns it
        # into global sample ids by fancy indexing.
        slow = cfg.straggler.slow_mask(topo.n)
        b_slow = max(1, int(cfg.batch_size / max(cfg.straggler.slowdown, 1.0)))
        flat_dev = plan.devices.reshape(-1)                       # (M*K,)
        idx_mat = self.data.client_idx                            # (n, max_size)
        cols = rng.integers(0, idx_mat.shape[1], size=(flat_dev.shape[0], cfg.batch_size))
        bidx = idx_mat[flat_dev[:, None], cols]
        if cfg.straggler.mode == "partial" and slow.any():
            reps = int(np.ceil(cfg.batch_size / b_slow))
            sub = idx_mat[flat_dev[:, None], cols[:, :b_slow]]
            tiled = np.tile(sub, (1, reps))[:, : cfg.batch_size]
            bidx = np.where(slow[flat_dev][:, None], tiled, bidx)
        bidx = bidx.reshape(m_chains, cfg.k_walk, cfg.batch_size)
        return plan, bidx

    def plan_aggregation(
        self, plan: WalkPlan, topo: Topology | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Build the round's (agg_devices, agg_rows, agg_weights) from the
        (possibly deadline-truncated) walk plan. Shapes are padded to fixed
        sizes (pad slots use device id >= n and zero weight; the round
        drops them) so every window of a run has the same shapes."""
        cfg, rng = self.cfg, self.rng
        topo = self.topo if topo is None else topo
        participants = np.unique(plan.devices[plan.mask])
        sizes = self.data.client_sizes
        if cfg.chain_mode:
            # §VI-F: N_A(i) = the other chains' end devices; aggregators are
            # exactly the (unique) chain-end devices, padded to M rows.
            # Zero-length chains (deadline/churn truncation to k_m = 0, or a
            # dropped straggler — never produced by the synchronous planner,
            # which floors k_m at 1) performed no step: their "end" device is
            # just the start device holding stale params, so they neither
            # aggregate nor contribute (zero weight).
            alive = plan.k_m > 0
            agg_devices = np.unique(plan.last_device[alive])
            rows = np.tile(plan.last_device, (len(agg_devices), 1))
            w = sizes[plan.last_device].astype(np.float64) * alive
            wsum = w.sum()
            weights = np.tile(w / (wsum if wsum > 0 else 1.0),
                              (len(agg_devices), 1))
            pad = cfg.m_chains - len(agg_devices)
            if pad > 0:
                # Distinct out-of-range ids (all pad slots are dropped).
                agg_devices = np.concatenate([agg_devices, topo.n + np.arange(pad)])
                rows = np.pad(rows, ((0, pad), (0, 0)))
                weights = np.pad(weights, ((0, pad), (0, 0)))
        elif getattr(topo, "transition", None) is None:
            # Implicit SparseTopology: same aggregation law as the dense
            # branch below (uniform aggregator draw; per aggregator a uniform
            # random subset of <= n_agg participating neighbors in uniform
            # random order; size-weights normalized over the selection; pads
            # carry the aggregator's own id and zero weight) realized as one
            # CSR gather + lexsort instead of a per-aggregator Python loop.
            # RNG consumption differs from the dense branch — the two
            # representations are distinct planners, not stream twins.
            n_aggregators = max(1, int(round(topo.n * cfg.agg_fraction)))
            agg_devices = rng.choice(topo.n, size=n_aggregators, replace=False)
            n_agg = cfg.n_agg
            deg = topo.degrees[agg_devices]
            total = int(deg.sum())
            starts = np.cumsum(deg) - deg
            offs = np.arange(total, dtype=np.int64) - np.repeat(starts, deg)
            flat = topo.indices[np.repeat(topo.indptr[agg_devices], deg) + offs]
            row_id = np.repeat(np.arange(n_aggregators, dtype=np.int64), deg)
            # The aggregator itself is always a candidate (include_self=True).
            flat = np.concatenate([flat, agg_devices])
            row_id = np.concatenate(
                [row_id, np.arange(n_aggregators, dtype=np.int64)])
            is_part = np.zeros(topo.n, dtype=bool)
            is_part[participants] = True
            keep = is_part[flat] | (flat == agg_devices[row_id])
            flat, row_id = flat[keep], row_id[keep]
            keys = rng.random(flat.shape[0])
            order = np.lexsort((keys, row_id))
            flat, row_id = flat[order], row_id[order]
            row_start = np.searchsorted(row_id, np.arange(n_aggregators))
            rank = np.arange(flat.shape[0], dtype=np.int64) - row_start[row_id]
            sel = rank < n_agg
            s_row, s_dev, s_rank = row_id[sel], flat[sel], rank[sel]
            rows = np.tile(agg_devices[:, None], (1, n_agg))
            weights = np.zeros((n_aggregators, n_agg), dtype=np.float64)
            rows[s_row, s_rank] = s_dev
            w_flat = sizes[s_dev].astype(np.float64)
            wsum = np.bincount(s_row, weights=w_flat, minlength=n_aggregators)
            weights[s_row, s_rank] = w_flat / np.maximum(wsum, 1.0)[s_row]
        else:
            n_aggregators = max(1, int(round(topo.n * cfg.agg_fraction)))
            agg_devices = rng.choice(topo.n, size=n_aggregators, replace=False)
            n_agg = cfg.n_agg
            row_list, weight_list = [], []
            part_set = set(participants.tolist())
            for i in agg_devices:
                nbrs = [j for j in topo.neighbors(i, include_self=True)
                        if j in part_set or j == i]
                rng.shuffle(nbrs)
                nbrs = np.array(nbrs[:n_agg], dtype=np.int64)
                pad = n_agg - len(nbrs)
                w = sizes[nbrs].astype(np.float64)
                w = w / max(w.sum(), 1.0)
                if pad > 0:
                    nbrs = np.pad(nbrs, (0, pad), constant_values=i)
                    w = np.pad(w, (0, pad))
                row_list.append(nbrs)
                weight_list.append(w)
            rows = np.stack(row_list)
            weights = np.stack(weight_list)
        agg_rows = rows.astype(np.int32)
        agg_w = weights.astype(np.float32)
        return (agg_devices.astype(np.int32), agg_rows, agg_w)

    def _comm_cost_bits(
        self, plan: WalkPlan, agg: tuple, d_params: int, bits: int | None = None,
    ) -> tuple[float, float]:
        """Eq. 18 comm accounting. Returns (total_bits, busiest_device_bits)."""
        bits = self.cfg.quant.bits if bits is None else int(bits)
        hop_bits = wire_bits(d_params, bits)
        n = self.topo.n
        # Walk hand-offs: each cross-device hop into an executed step sends
        # params (or a quantized diff); the sender pays.
        src = plan.devices[:, :-1]
        dst = plan.devices[:, 1:]
        live = plan.mask[:, 1:] & (src != dst)
        per_dev = np.bincount(src[live].ravel(), minlength=n).astype(np.float64)
        # Aggregation: each participating device l sends its (quantized diff)
        # model to the aggregators that list it.
        agg_devices, agg_rows, agg_w = agg
        sends = (agg_w > 0) & (agg_rows != agg_devices[:, None])
        per_dev += np.bincount(agg_rows[sends].ravel(), minlength=n)
        per_dev *= hop_bits
        return float(per_dev.sum()), float(per_dev.max())

    # ------------------------------------------------------------------- run
    def run_round(self, state: DFedRWState, key: torch.Generator
                  ) -> tuple[DFedRWState, RoundMetrics]:
        if self.obs is None:
            plan, bidx, agg = self._plan_round(state)
        else:
            with self.obs.span("engine/plan"):
                plan, bidx, agg = self._plan_round(state)
        return self.execute_round(state, plan, bidx, agg, key)

    def execute_round(
        self,
        state: DFedRWState,
        plan: WalkPlan,
        bidx: np.ndarray,
        agg: tuple,
        key: torch.Generator | None,
        account_plan: WalkPlan | None = None,
        bits: int | None = None,
        qseeds=None,
        uniforms=None,
    ) -> tuple[DFedRWState, RoundMetrics]:
        """Run one planned round and update the protocol state.

        ``account_plan`` charges Eq. 18 comm for a different plan than the
        one computed; ``bits`` overrides the config's wire width for this
        round. Flat engine: ``qseeds`` is a (K+1, 2) array of uint32 seed
        words for the K hop payloads and the one aggregation payload; when
        None (and the round is quantized) they are drawn from the generator
        ``key``. Reference engine: ``uniforms`` is ``{"hop": hop, "agg":
        agg}``, the stochastic-rounding uniforms in the reference's draw
        order, ``hop[k][leaf]`` of shape (M, *leaf) and ``agg[leaf]`` of
        shape (A * n_agg, *leaf); when None (and the round is quantized)
        they are drawn from ``key``, or from a generator on the engine's
        device seeded from ``key`` when ``key`` lies elsewhere."""
        cfg = self.cfg
        obs = self.obs
        t_obs = obs.clock.now() if obs is not None else 0.0
        bits_eff = validate_wire_bits(cfg.quant.bits if bits is None else int(bits))
        if cfg.engine == "reference":
            if qseeds is not None:
                raise ValueError("qseeds salt the flat engine's kernels; the reference "
                                 "engine takes uniforms")
            gen = None
            if bits_eff < 32 and uniforms is None:
                if key is None:
                    raise ValueError("a quantized round needs a generator or uniforms")
                gen = key
                if torch.device(key.device).type != self.device.type:
                    gen = torch.Generator(device=self.device)
                    gen.manual_seed(int(torch.randint(0, 1 << 62, (1,), generator=key)))
            new_params, loss, gamma_hat = self._round_reference(
                state.device_params, plan, bidx, agg, state.global_step, bits_eff,
                uniforms if bits_eff < 32 else None, gen)
        else:
            if uniforms is not None:
                raise ValueError("uniforms feed the reference engine; the flat engine takes "
                                 "qseeds")
            if bits_eff < 32:
                if qseeds is None:
                    if key is None:
                        raise ValueError("a quantized round needs a generator or qseeds")
                    qseeds = torch.randint(0, 1 << 32, (cfg.k_walk + 1, 2),
                                           generator=key, dtype=torch.int64)
                qseeds = [(int(a), int(b)) for a, b in np.asarray(qseeds).tolist()]
                if len(qseeds) != cfg.k_walk + 1:
                    raise ValueError(f"qseeds needs {cfg.k_walk + 1} rows, got {len(qseeds)}")
            new_params, loss, gamma_hat = self._round_flat(
                state.device_params, plan, bidx, agg, state.global_step, bits_eff, qseeds)
        self._programs_run.add(bits_eff)
        acct = plan if account_plan is None else account_plan
        tot, busiest = self._comm_cost_bits(acct, agg, self.flat_spec.d, bits=bits_eff)
        agg_devices = agg[0]
        updated = (state.updated.copy() if state.updated is not None
                   else np.zeros(self.topo.n, dtype=bool))
        updated[np.unique(plan.devices[plan.mask])] = True
        updated[agg_devices[agg_devices < self.topo.n]] = True
        new_state = DFedRWState(
            device_params=new_params,
            round=state.round + 1,
            global_step=state.global_step + cfg.k_walk,
            chain_starts=plan.last_device if cfg.chain_mode else None,
            comm_bits_total=state.comm_bits_total + tot,
            comm_bits_busiest=state.comm_bits_busiest + busiest,
            updated=updated,
        )
        metrics = RoundMetrics(
            round=new_state.round,
            train_loss=float(loss),
            comm_bits_round=tot,
            comm_bits_busiest_round=busiest,
            gamma_hat=float(gamma_hat),
        )
        if obs is not None:
            obs.record_span("engine/execute_round", t_obs, obs.clock.now())
            obs.counter("engine/rounds")
            obs.counter("engine/programs", 1, bits=bits_eff)
            obs.counter("engine/comm_bits", tot, bits=bits_eff)
            obs.counter("engine/comm_bits_busiest", busiest)
            obs.counter("engine/steps_executed", int(plan.mask.sum()))
            obs.flush()
        return new_state, metrics
