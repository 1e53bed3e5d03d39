"""The traffic generator: one epoch per seed, each field's ids inside its
own slice, the slices as the mix states them."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import traffic


@pytest.fixture
def mix():
    return traffic.load_mix("fields")


def small(mix, rows=512):
    m = dict(mix)
    m["rows"] = rows
    return m


def test_cardinalities_sum_as_stated(mix):
    cards = traffic.cardinalities(mix)
    assert len(cards) == 39
    assert cards[:13] == [256] * 13
    assert sum(mix["categorical_cardinalities"]) == 204_184_588
    assert traffic.rows_used(mix) == 204_187_916 <= 2**28
    assert max(cards) == 40_000_000


def test_same_seed_same_epoch_other_seed_other(mix):
    kw = dict(batch_size=64, n_fields=39, vocabulary_size=2**28, device="cpu")
    a = traffic.make_epoch(small(mix), seed=2**33 + 7, **kw)
    b = traffic.make_epoch(small(mix), seed=2**33 + 7, **kw)
    c = traffic.make_epoch(small(mix), seed=2**33 + 8, **kw)
    for name in ("labels", "ids", "vals", "weights"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert not torch.equal(a.ids, c.ids)
    assert a.batches == 8 and a.ids.dtype == torch.int32


def test_each_field_stays_in_its_slice(mix):
    ep = traffic.make_epoch(small(mix, 2048), batch_size=64, n_fields=39,
                            vocabulary_size=2**28, seed=5, device="cpu")
    ids = ep.ids.long().numpy()
    off = np.array(traffic.slice_offsets(mix))
    card = np.array(traffic.cardinalities(mix))
    assert (ids >= off).all() and (ids < off + card).all()
    # one id belongs to one field, so no example holds an id twice
    assert all(len(set(row)) == 39 for row in ids[:256].tolist())
    # the 3-valued field's hottest value dominates (Zipf per field)
    f = 13 + 5
    v = ids[:, f] - off[f]
    assert set(np.unique(v)) <= {0, 1, 2} and (v == 0).mean() > 0.3
    assert (ep.vals == 1.0).all() and (ep.weights == 1.0).all()


def test_click_rate_and_zipf_draws(mix):
    g = torch.Generator().manual_seed(3)
    z = traffic.zipf(200_000, 1.1, g)
    assert int(z.min()) >= 1
    # P(z = 1) = 1 / zeta(1.1) = 0.0945
    assert abs(float((z == 1).double().mean()) - 0.0945) < 0.005
    ep = traffic.make_epoch(small(mix, 65536), batch_size=65536, n_fields=39,
                            vocabulary_size=2**28, seed=9, device="cpu")
    assert abs(float(ep.labels.mean()) - mix["click_rate"]) < 0.003


def test_refuses_what_does_not_fit(mix):
    with pytest.raises(ValueError, match="fields"):
        traffic.make_epoch(small(mix), batch_size=64, n_fields=38, vocabulary_size=2**28,
                           seed=1, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        traffic.make_epoch(small(mix), batch_size=64, n_fields=39, vocabulary_size=2**20,
                           seed=1, device="cpu")
    with pytest.raises(ValueError, match="whole number"):
        traffic.make_epoch(small(mix, 500), batch_size=64, n_fields=39, vocabulary_size=2**28,
                           seed=1, device="cpu")
