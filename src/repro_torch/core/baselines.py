"""Baselines the paper compares against (§VI-B), the port of
``repro.core.baselines``: FedAvg [33], DFedAvg [15] (DFedAvgM with
``momentum > 0``) and DSGD.

Like the DFedRW engine, the baselines run on the flat parameter buffer
(repro_torch.core.flatten): device models are rows of one (n, d_pad)
matrix, the local-epoch loop is E steps of per-row gradients
(``torch.func.vmap(torch.func.grad(...))``), and QDFedAvg's aggregation
diffs (Fig. 9) go through ONE fused qdq kernel call for the whole payload
(``payload_quantize_dequantize``, kernel B2 on a CUDA tensor).

The host side (selection, straggler drop, batches, neighbor shuffles)
consumes the protocol rng line for line as the reference does, so one
``seed`` gives the same selections, batches and Eq. 18 bits.

All baselines *drop stragglers* (the paper's point of contrast): under h%
system heterogeneity, straggler devices neither update nor contribute to
aggregation in that round.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dfedrw import DFedRWState, FlatRunner, RoundMetrics
from repro_torch.core.flatten import FlatSpec
from repro_torch.core.quantization import QuantConfig, wire_bits
from repro_torch.core.walk import StragglerModel
from repro_torch.kernels.quantize import payload_quantize_dequantize
from repro_torch.optim.sgd import decreasing_lr

__all__ = ["BaselineConfig", "FedAvg", "DFedAvg", "DSGD"]


def _quant_agg(buf: torch.Tensor, start_buf: torch.Tensor, agg_rows: torch.Tensor,
               agg_w: torch.Tensor, sel: torch.Tensor, spec: FlatSpec, quant: QuantConfig,
               seed) -> torch.Tensor:
    """Eq. 14 with quantized diffs (QDFedAvg, Fig. 9): the (S, n_agg)
    messages ``buf[agg_rows] - start_buf[agg_rows]`` as ONE
    ``payload_quantize_dequantize`` call on the (S * n_agg, d_pad) payload,
    then each selected row set to ``start_buf[row] + sum(agg_w * deq)``.
    ``seed`` is the pair of uint32 words of the call. Writes ``buf``."""
    a, g = agg_rows.shape
    diffs = buf[agg_rows] - start_buf[agg_rows]                 # (S, n_agg, d_pad)
    deq = payload_quantize_dequantize(
        diffs.reshape(a * g, spec.d_pad), spec, per_message=True, bits=quant.bits,
        s=quant.s, seed=seed).reshape(a, g, spec.d_pad)
    upd = torch.sum(agg_w[..., None] * deq, dim=1)
    return buf.index_copy_(0, sel, start_buf[sel] + upd)


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    n_selected: int = 5            # devices (or aggregators) per round
    local_epochs: int = 5          # E local SGD steps between aggregations
    batch_size: int = 50
    lr_r: float = 5.0
    lr_q: float = 0.499
    n_agg: int = 5                 # |N_A(i)| for decentralized baselines
    momentum: float = 0.0          # >0: DFedAvgM [15] -- momentum applied
                                   # during the local-epoch loop
    straggler: StragglerModel = dataclasses.field(default_factory=StragglerModel)
    quant: QuantConfig = dataclasses.field(default_factory=lambda: QuantConfig(bits=32))
    seed: int = 0


class _Base(FlatRunner):
    """The baselines' shared host side (selection with the straggler drop,
    batches, the skipped round) and local-epoch loop."""

    def _local_updates(self, params_sel: torch.Tensor, bidx: np.ndarray,
                       kbar0: int) -> torch.Tensor:
        """E local SGD steps of the (S, d_pad) rows on their (S, E, B)
        batches, with step size eta^(kbar0 + e + 1); with cfg.momentum > 0
        this is DFedAvgM's local loop [15]."""
        cfg = self.cfg
        bidx_t = torch.from_numpy(np.ascontiguousarray(bidx.swapaxes(0, 1))).to(self.device)
        xb_all, yb_all = self._x[bidx_t], self._y[bidx_t]    # (E, S, B, ...)
        p, vel = params_sel, torch.zeros_like(params_sel)
        for e in range(bidx.shape[1]):
            lr = decreasing_lr(kbar0 + e + 1, cfg.lr_r, cfg.lr_q)
            g = self._grad_fn(p, xb_all[e], yb_all[e])
            vel_new = cfg.momentum * vel + g
            p = p - lr * vel_new
            if cfg.momentum > 0:
                vel = vel_new
        return p

    def _select(self, drop_stragglers: bool = True) -> np.ndarray:
        """Baselines drop any selected persistently-slow device (it cannot
        finish E local epochs within the global clock) -- the sampling bias
        the paper criticizes. Slow devices' data is thus never trained on."""
        cfg = self.cfg
        sel = self.rng.choice(self.topo.n, size=min(cfg.n_selected, self.topo.n), replace=False)
        if drop_stragglers and cfg.straggler.h_percent > 0:
            slow = cfg.straggler.slow_mask(self.topo.n)
            sel = sel[~slow[sel]]
        return np.sort(sel)

    def _skip_round(self, state: DFedRWState) -> tuple[DFedRWState, RoundMetrics]:
        """All selected devices were stragglers: the round produces no update
        (the server/neighbors time out) -- the data-loss failure mode the
        paper attributes to (D)FedAvg."""
        new_state = dataclasses.replace(state, round=state.round + 1)
        return new_state, RoundMetrics(
            round=new_state.round,
            train_loss=float("nan"),
            comm_bits_round=0.0,
            comm_bits_busiest_round=0.0,
            gamma_hat=1.0,
        )

    def _batches(self, sel: np.ndarray, epochs: int) -> np.ndarray:
        """(S, E, B) global sample indices: one rng draw + fancy indexing."""
        cfg = self.cfg
        idx_mat = self.data.client_idx                       # (n, max_size)
        cols = self.rng.integers(
            0, idx_mat.shape[1], size=(len(sel), epochs, cfg.batch_size)
        )
        return idx_mat[np.asarray(sel)[:, None, None], cols]

    def _mean_loss(self, params_sel: torch.Tensor, bidx_last: np.ndarray) -> float:
        idx = torch.from_numpy(bidx_last).to(self.device)
        return float(self._loss_fn(params_sel, self._x[idx], self._y[idx]).mean())


class FedAvg(_Base):
    """Centralized FedAvg [33]: the server broadcasts the global model to S
    selected devices, which run E local epochs; weighted average back."""

    def run_round(self, state: DFedRWState, key: torch.Generator | None = None,
                  qseed=None) -> tuple[DFedRWState, RoundMetrics]:
        """One round. FedAvg sends unquantized models: ``key`` and ``qseed``
        are taken for a common signature and unused; the wire width only
        prices Eq. 18."""
        cfg = self.cfg
        # Global model = row 0 (all rows kept in sync).
        sel = self._select()
        if len(sel) == 0:
            return self._skip_round(state)
        bidx = self._batches(sel, cfg.local_epochs)
        params_sel = state.device_params[:1].repeat(len(sel), 1)
        out = self._local_updates(params_sel, bidx, state.global_step)
        sizes = self.data.client_sizes[sel].astype(np.float64)
        w = torch.from_numpy((sizes / sizes.sum()).astype(np.float32)).to(self.device)
        new_global = w @ out                                   # (d_pad,)
        new_stack = new_global[None, :].repeat(self.topo.n, 1)
        phi = wire_bits(self.flat_spec.d, cfg.quant.bits)
        tot = 2.0 * len(sel) * phi           # server <-> each selected device
        busiest = tot                         # the server is the busiest node
        new_state = DFedRWState(
            device_params=new_stack,
            round=state.round + 1,
            global_step=state.global_step + cfg.local_epochs,
            comm_bits_total=state.comm_bits_total + tot,
            comm_bits_busiest=state.comm_bits_busiest + busiest,
            updated=np.ones(self.topo.n, dtype=bool),
        )
        return new_state, RoundMetrics(
            round=new_state.round,
            train_loss=self._mean_loss(out, bidx[:, -1]),
            comm_bits_round=tot,
            comm_bits_busiest_round=busiest,
            gamma_hat=1.0,
        )


class DFedAvg(_Base):
    """Decentralized FedAvg (DFedAvgM without momentum, [15]): every
    non-straggler selected device runs E local epochs on its *own* data,
    then aggregates with <= n_agg random graph neighbors (Eq. 11);
    optionally with quantized diffs (QDFedAvg, Fig. 9) through one fused
    kernel call a round."""

    def run_round(self, state: DFedRWState, key: torch.Generator | None = None,
                  qseed=None) -> tuple[DFedRWState, RoundMetrics]:
        """One round. A quantized round draws its two uint32 seed words from
        the generator ``key``, unless ``qseed`` gives them."""
        return self._round(state, key, qseed, self.cfg.local_epochs)

    def _round(self, state, key, qseed, epochs):
        cfg = self.cfg
        spec = self.flat_spec
        sel = self._select()
        if len(sel) == 0:
            return self._skip_round(state)
        bidx = self._batches(sel, epochs)
        sel_t = torch.from_numpy(sel.astype(np.int64)).to(self.device)
        out = self._local_updates(state.device_params[sel_t], bidx, state.global_step)

        # Scatter updated params back, then neighbor aggregation among sel.
        device_params = state.device_params.index_copy(0, sel_t, out)
        sizes = self.data.client_sizes
        sel_set = set(sel.tolist())
        rows, weights = [], []
        for i in sel:
            nbrs = [j for j in self.topo.neighbors(i, include_self=True) if j in sel_set]
            self.rng.shuffle(nbrs)
            nbrs = np.array(nbrs[: cfg.n_agg], dtype=np.int64)
            pad = cfg.n_agg - len(nbrs)
            w = sizes[nbrs].astype(np.float64)
            w = w / max(w.sum(), 1.0)
            if pad > 0:
                nbrs = np.pad(nbrs, (0, pad), constant_values=i)
                w = np.pad(w, (0, pad))
            rows.append(nbrs)
            weights.append(w)
        row_mat = np.stack(rows)
        w_mat = np.stack(weights)
        agg_rows = torch.from_numpy(row_mat).to(self.device)
        agg_w = torch.from_numpy(w_mat.astype(np.float32)).to(self.device)

        if cfg.quant.enabled:
            if qseed is None:
                if key is None:
                    raise ValueError("a quantized round needs a generator or qseed")
                qseed = torch.randint(0, 1 << 32, (2,), generator=key, dtype=torch.int64)
            seed = tuple(int(v) for v in np.asarray(qseed).reshape(-1)[:2])
            device_params = _quant_agg(device_params, state.device_params, agg_rows,
                                       agg_w, sel_t, spec, cfg.quant, seed)
        else:
            gathered = device_params[agg_rows]                  # (S, n_agg, d_pad)
            avg = torch.sum(agg_w[..., None] * gathered, dim=1)
            device_params = device_params.index_copy_(0, sel_t, avg)

        phi = wire_bits(spec.d, cfg.quant.bits)
        sends = (w_mat > 0) & (row_mat != sel[:, None])
        per_dev = np.bincount(
            row_mat[sends].ravel(), minlength=self.topo.n
        ).astype(np.float64) * phi
        tot, busiest = float(per_dev.sum()), float(per_dev.max())
        updated = (state.updated.copy() if state.updated is not None
                   else np.zeros(self.topo.n, dtype=bool))
        updated[sel] = True
        new_state = DFedRWState(
            device_params=device_params,
            round=state.round + 1,
            global_step=state.global_step + epochs,
            comm_bits_total=state.comm_bits_total + tot,
            comm_bits_busiest=state.comm_bits_busiest + busiest,
            updated=updated,
        )
        return new_state, RoundMetrics(
            round=new_state.round,
            train_loss=self._mean_loss(out, bidx[:, -1]),
            comm_bits_round=tot,
            comm_bits_busiest_round=busiest,
            gamma_hat=1.0,
        )


class DSGD(DFedAvg):
    """Decentralized SGD: one local step then neighbor mixing, every round
    (DFedAvg with ``local_epochs=1``, whatever the config says)."""

    def run_round(self, state: DFedRWState, key: torch.Generator | None = None,
                  qseed=None) -> tuple[DFedRWState, RoundMetrics]:
        return self._round(state, key, qseed, 1)
