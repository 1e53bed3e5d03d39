"""The one traffic generator: a resident training epoch of field-indexed CTR
examples, made from ``--seed`` on the device.

A mix (``benchmark/traffic/<name>.json``) holds only parameters:

* ``rows``: the examples of the epoch, a whole number of batches;
* ``batch_size``: the batch, or null for the configuration's own;
* ``integer_fields`` / ``integer_buckets``: the leading bucketized integer
  fields, each with that many values;
* ``categorical_cardinalities``: the values of each categorical field;
  each field takes a slice of the table of its own (``id = offset_f +
  v``, the slices end to end), so an id belongs to one field and occurs
  at most once per example;
* ``zipf_exponent``: each value is ``v = (z - 1) mod c_f`` with ``z ~
  Zipf(a)`` drawn per field and example;
* ``value``: every feature's value (1.0: binary one-hot features);
* ``click_rate``: each label is 1 with this probability, independent of
  the features.

The draws run on the generator's device in a few large calls: Zipf by
the rejection method numpy's ``zipf`` uses (Devroye), vectorised, with
draws above 2**63 rejected as numpy rejects them.  The same seed on the
same kind of device gives the same epoch.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

__all__ = ["Epoch", "load_mix", "cardinalities", "slice_offsets", "sub_seed", "zipf",
           "make_epoch"]


@dataclasses.dataclass
class Epoch:
    """Flat row-major arrays of one epoch, ``batches`` batches of
    ``batch_size`` rows, batch ``i`` at rows ``[i·B, (i+1)·B)``."""

    labels: torch.Tensor  # f32 [rows]
    ids: torch.Tensor  # i32 [rows, N]
    vals: torch.Tensor  # f32 [rows, N]
    weights: torch.Tensor  # f32 [rows]
    batch_size: int

    @property
    def batches(self) -> int:
        return self.labels.shape[0] // self.batch_size

    def batch(self, i: int) -> dict:
        """Batch ``i`` as views of the epoch's arrays."""
        lo, hi = i * self.batch_size, (i + 1) * self.batch_size
        return {"labels": self.labels[lo:hi], "ids": self.ids[lo:hi], "vals": self.vals[lo:hi],
                "weights": self.weights[lo:hi]}


def load_mix(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    if mix.get("name") != name:
        raise ValueError(f"traffic/{name}.json names itself {mix.get('name')!r}")
    return mix


def cardinalities(mix: dict) -> list[int]:
    """Each field's number of values, in the examples' slot order: the
    integer fields first, then the categorical ones."""
    return ([int(mix["integer_buckets"])] * int(mix["integer_fields"])
            + [int(c) for c in mix["categorical_cardinalities"]])


def slice_offsets(mix: dict) -> list[int]:
    """Each field's first row: the slices end to end."""
    return [int(x) for x in np.concatenate([[0], np.cumsum(cardinalities(mix))[:-1]])]


def rows_used(mix: dict) -> int:
    """The table rows the mix's ids can reach."""
    return sum(cardinalities(mix))


def sub_seed(seed: int, tag: int) -> int:
    """A 64-bit generator seed for one purpose (``tag``) of a run's seed."""
    return int(np.random.SeedSequence([seed % 2**64, tag]).generate_state(1, np.uint64)[0])


def zipf(n: int, a: float, generator: torch.Generator) -> torch.Tensor:
    """``n`` Zipf(a) draws, int64 >= 1, on the generator's device."""
    device = generator.device
    am1 = a - 1.0
    b = 2.0**am1
    out = torch.empty(n, dtype=torch.int64, device=device)
    pending = torch.arange(n, device=device)
    while pending.numel():
        m = pending.numel()
        u = 1.0 - torch.rand(m, dtype=torch.float64, generator=generator, device=device)
        v = torch.rand(m, dtype=torch.float64, generator=generator, device=device)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = (x < 2.0**63) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out[pending[ok]] = x[ok].to(torch.int64)
        pending = pending[~ok]
    return out


def make_epoch(mix: dict, *, batch_size: int, n_fields: int, vocabulary_size: int, seed: int,
               device) -> Epoch:
    """The mix's epoch at ``batch_size`` for a model of ``n_fields`` slots
    over ``vocabulary_size`` rows, drawn from ``seed`` on ``device``."""
    cards = cardinalities(mix)
    rows = int(mix["rows"])
    if len(cards) != n_fields:
        raise ValueError(f"mix {mix['name']} has {len(cards)} fields, the model {n_fields} slots")
    if rows_used(mix) > vocabulary_size:
        raise ValueError(f"mix {mix['name']} reaches {rows_used(mix)} rows, the table has "
                         f"{vocabulary_size}")
    if rows % batch_size:
        raise ValueError(f"mix {mix['name']}: {rows} rows is not a whole number of batches "
                         f"of {batch_size}")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    z = zipf(rows * n_fields, float(mix["zipf_exponent"]), gen).view(rows, n_fields)
    card = torch.tensor(cards, dtype=torch.int64, device=device)
    off = torch.tensor(slice_offsets(mix), dtype=torch.int64, device=device)
    ids = ((z - 1) % card + off).to(torch.int32)
    del z
    labels = (torch.rand(rows, generator=gen, device=device) < float(mix["click_rate"])).float()
    return Epoch(
        labels=labels,
        ids=ids,
        vals=torch.full((rows, n_fields), float(mix["value"]), device=device),
        weights=torch.ones(rows, device=device),
        batch_size=batch_size,
    )
