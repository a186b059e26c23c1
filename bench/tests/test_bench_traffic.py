"""The traffic generator: the same seed gives the same inputs, every seed
the same mix of lengths, and the training batches are the port's."""
from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest

from bench import generator as T
from bench.harness import derive_seed
from bench.tests.helpers import BENCH

MIX = json.loads((BENCH / "traffic" / "prefill-mix.json").read_text())
TRAIN = json.loads((BENCH / "traffic" / "train-16k.json").read_text())
BIG = 2**31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG, 2**40 + 3])
def test_prefill_mix_repeats_and_meets_the_shares(seed):
    order = T.prefill_cycle(MIX, seed)
    assert order == T.prefill_cycle(MIX, seed)
    n = len(order)
    counts = Counter(order)
    for S, share in zip(MIX["seq_lens"], MIX["shares"]):
        assert counts[S] == round(share * n)
    assert {T.prefill_shape(MIX, S)[0] * S for S in order} == \
        {MIX["tokens_per_batch"]}
    a = T.PrefillTokens(MIX, seed, 50304)
    b = T.PrefillTokens(MIX, seed, 50304)
    for i in range(3):
        x, y = a.next(i), b.next(i)
        assert x.dtype == np.int32 and x.shape == T.prefill_shape(
            MIX, order[i])
        assert np.array_equal(x, y) and 0 <= x.min() and x.max() < 50304
    sample = T.prefill_sample(MIX, seed)
    assert sample == T.prefill_sample(MIX, seed)
    assert len(set(sample)) == MIX["sample_batches"]
    assert 0 <= min(sample) and max(sample) < MIX["sample_of"]
    lens = [order[i % n] for i in sample]
    assert max(MIX["seq_lens"]) in lens
    # some hundreds of rows are checked
    assert sum(T.prefill_shape(MIX, S)[0] for S in lens) >= 200


def test_seeds_order_the_same_mix_differently():
    a, b = T.prefill_cycle(MIX, 1), T.prefill_cycle(MIX, 2)
    assert sorted(a) == sorted(b) and a != b
    x = T.PrefillTokens(MIX, 1, 1000).next(0)
    y = T.PrefillTokens(MIX, 2, 1000).next(0)
    assert x.shape != y.shape or not np.array_equal(x, y)


def test_bad_shares_are_refused():
    with pytest.raises(ValueError):
        T.prefill_cycle(dict(MIX, shares=[0.5, 0.3, 0.1, 0.1], cycle=7), 0)


@pytest.mark.parametrize("change", [{"loop": "open"}, {"in_flight": 4}])
def test_a_loop_the_driver_lacks_is_refused(change):
    with pytest.raises(ValueError, match="closed loop"):
        T.PrefillTokens(dict(MIX, **change), 1, 1000)


def test_train_batches_are_the_ports():
    from repro_torch.train.data import DataConfig, synthetic_batch
    mix = dict(TRAIN, global_batch=2, seq_len=64)
    for step in (0, 3):
        got = T.train_batch(mix, 99, step, 500)["tokens"]
        want = synthetic_batch(DataConfig(vocab=500, seq_len=64,
                                          global_batch=2, seed=99,
                                          motif_len=8), step)["tokens"]
        assert np.array_equal(got, want)
    assert not np.array_equal(T.train_batch(mix, 99, 0, 500)["tokens"],
                              T.train_batch(mix, 99, 1, 500)["tokens"])


def test_derived_seeds_take_any_whole_number():
    for s in (0, 1, -5, BIG, 2**63 + 1):
        a = derive_seed(s, 1)
        assert a == derive_seed(s, 1) and 0 <= a < 2**63
        assert a != derive_seed(s, 2)
    assert derive_seed(5, 1) != derive_seed(-5, 1)
