"""The port as the benchmark drives it on the rows layout, built from a
configuration file: the port's own ``Config`` and ``build_model``, a
rows-layout ``TrainState`` on the benchmark's starting weights, the resident epoch as
a ``DeviceDataset``, and the resident-epoch K-step call that
``training._device_cached_input`` builds
(``make_cached_scan_train_step``'s unshuffled step, a ``StepGraphs``
replaying ``trainer.train_step_body`` K times on the card).
"""

from __future__ import annotations

import dataclasses

import torch

from fast_tffm_tpu_torch.config import Config, build_model
from fast_tffm_tpu_torch.data.device_cache import (
    DeviceDataset,
    epoch_index_chunks,
    make_cached_scan_train_step,
)
from fast_tffm_tpu_torch.optim import init_table_adagrad
from fast_tffm_tpu_torch.trainer import TrainState

__all__ = ["port_config", "Program"]


def port_config(cfg: dict) -> Config:
    """The port's ``Config`` from the configuration file's keys that it has
    (the rest describe the file); checked by the port's own validation
    where it has one."""
    names = {f.name for f in dataclasses.fields(Config)}
    keys = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg.items() if k in names}
    out = Config(**keys)
    if out.table_layout != "rows" or not out.device_cache or out.shuffle:
        raise ValueError("the benchmark drives the rows layout's unshuffled resident epoch")
    return out


class Program:
    """One training run of the port: ``call(idxs)`` is one K-step call on
    the resident batches ``idxs``; ``snapshot(rows)`` copies to the host the
    state a comparison reads; ``sync()`` closes a timing window."""

    def __init__(self, cfg: dict, epoch, table: torch.Tensor, dense: dict, device):
        self.config = c = port_config(cfg)
        self.model = build_model(c)
        self.k = c.steps_per_call
        self.device = torch.device(device)
        self.state = TrainState(
            table=table,
            dense=[dense[n] for n in self.model.dense_names],
            step=0,
            table_accum=init_table_adagrad(table, c.init_accumulator_value, c.adagrad_accumulator),
            dense_accum=[torch.full_like(dense[n], c.init_accumulator_value)
                         for n in self.model.dense_names],
        )
        rows, n = epoch.ids.shape
        fields = (torch.arange(n, dtype=torch.int32, device=self.device).expand(rows, n).contiguous()
                  if self.model.uses_fields else
                  torch.zeros((rows, 0), dtype=torch.int32, device=self.device))
        self.data = DeviceDataset(
            labels=epoch.labels, ids=epoch.ids, vals=epoch.vals, fields=fields,
            weights=epoch.weights, batches=epoch.batches, batch_size=epoch.batch_size,
            n_rows=rows, offsets=torch.arange(epoch.batch_size, dtype=torch.int64, device=self.device),
        )
        self.step = make_cached_scan_train_step(self.model, c.learning_rate, self.data)[0]

    def call(self, idxs: torch.Tensor) -> torch.Tensor:
        """One call: the steps on batches ``idxs``; their data losses [K]."""
        self.state, losses = self.step(self.state, idxs)
        return losses

    def chunks(self) -> list[torch.Tensor]:
        """The epoch's [K] batch-index chunks, in order."""
        return epoch_index_chunks(self.data.batches, self.k, self.device)

    def snapshot(self, rows: torch.Tensor) -> dict:
        """The state a comparison reads, on the host: the table's and the
        accumulator's ``rows``, and the dense leaves and their
        accumulators by name."""
        s = self.state
        idx = rows.to(s.table.device)
        names = self.model.dense_names
        return {
            "table": s.table.index_select(0, idx).to("cpu", copy=True),
            "accum": s.table_accum.index_select(0, idx).to("cpu", copy=True),
            "dense": {n: p.detach().to("cpu", copy=True) for n, p in zip(names, s.dense)},
            "dense_accum": {n: a.to("cpu", copy=True) for n, a in zip(names, s.dense_accum)},
        }

    def sync(self) -> float:
        """Close a timing window: ``torch.cuda.synchronize()`` and a read of
        two table rows, which cannot complete before every queued update to
        the table has (bench_torch.forced_sync's rule)."""
        table = self.state.table
        if table.device.type == "cuda":
            torch.cuda.synchronize(table.device)
        return float(table[:2].sum())
