"""Fixtures of the benchmark's CPU tests: cells cut to a size a test run
holds (a 4,096-row table, 64-row batches, a 16-batch epoch), keeping
every key and path of the real cell."""

from __future__ import annotations

from benchmark import harness

TINY_CARDS = [100, 3, 50, 4, 7] + [20] * 21


def tiny_spec(cell: str, batch: int = 64, batches: int = 16) -> dict:
    spec = harness.load_spec(cell)
    cfg, mix = dict(spec["config"]), dict(spec["mix"])
    cfg["vocabulary_size"] = 4096
    if cfg["model"] == "deepfm":
        cfg["hidden_dims"] = [16, 16]
    mix.update(integer_buckets=8, categorical_cardinalities=TINY_CARDS, rows=batch * batches,
               batch_size=batch)
    spec["config"], spec["mix"] = cfg, mix
    return spec

