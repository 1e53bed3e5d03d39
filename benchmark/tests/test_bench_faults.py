"""``correct`` comes out false when the timed path is broken underneath,
and the control (the reference one precision below the configuration's,
in the port's place) fails the cell's limits.  Each drives the rest of a
run on the CPU at a tiny size, without the harness's look for a card.

Faults a training cell on one card can have: a step that returns its
state unchanged; half of the batch left out, the mean taken over the
rest.  (No exchange between cards; no answer is served.)"""

from __future__ import annotations

import time

import pytest
import torch

import fast_tffm_tpu_torch.data.device_cache as device_cache
from benchmark import check, control, harness
from benchmark.tests.conftest import tiny_spec
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.trainer import batch_loss

CELLS = ["fm2_criteo1tb.fields", "deepfm_criteo1tb.fields"]


def run(spec, seed=2**33 + 1, trace=False):
    limits = check.load_limits(spec["cell"]["name"], harness.HERE)
    return harness.run_cell(spec, seed, 0.2, trace, "cpu", time.perf_counter(), limits=limits,
                            log=lambda *a, **k: None)


def unchanged_body(model, learning_rate, state, batch, decay=1.0):
    _, data_loss = batch_loss(model, state.table[batch.ids], state.dense, batch)
    state.step += 1
    return state, data_loss.detach()


def half_batch(orig):
    def gather(data, i, shuffled):
        b = orig(data, i, shuffled)
        w = b.weights.clone()
        w[w.shape[0] // 2:] = 0.0
        return Batch(b.labels, b.ids, b.vals, b.fields, w)

    return gather


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = run(tiny_spec(cell))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"examples_per_s", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_keeps_its_state_is_caught(cell, monkeypatch):
    monkeypatch.setattr(device_cache, "train_step_body", unchanged_body)
    res = run(tiny_spec(cell))
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_is_caught(cell, monkeypatch):
    monkeypatch.setattr(device_cache, "_batch", half_batch(device_cache._batch))
    res = run(tiny_spec(cell))
    assert not res["correct"], res["checks"]


def test_a_traced_run_judges_the_same(monkeypatch):
    spec = tiny_spec("fm2_criteo1tb.fields")
    assert run(spec, trace=True)["correct"]
    monkeypatch.setattr(device_cache, "train_step_body", unchanged_body)
    assert not run(spec, trace=True)["correct"]


@pytest.mark.parametrize("cell,kind", [(c, "control") for c in CELLS]
                         + [("deepfm_criteo1tb.fields", "control_mlp")])
def test_the_control_fails_the_limits(cell, kind):
    spec = tiny_spec(cell, batch=256)
    limits = check.load_limits(cell, harness.HERE)
    for seed in (1, 2, 3):
        r = control.seed_readings(spec, seed, torch.device("cpu"), [kind])
        assert check.judge(r["program"], limits)[0], r
        assert not check.judge(r[kind], limits)[0], r


def test_the_mlp_control_applies_only_to_a_bf16_mlp():
    r = control.seed_readings(tiny_spec(CELLS[0], batch=256), 1, torch.device("cpu"),
                              ["control_mlp"])
    assert set(r) == {"program"}
