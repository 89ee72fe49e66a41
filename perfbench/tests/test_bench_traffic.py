"""The traffic generator: deterministic under the seed, the same sizes for
every seed, lengths from the mix's distribution."""

import collections
import json
import statistics

import numpy as np
import pytest
from yardstick import traffic
from yardstick.cell import HERE


def mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat", "rag"])
def test_open_schedule_repeats_under_its_seed(name):
    a = traffic.open_schedule(mix(name), 3.0, 20.0, 40.0, 2 ** 31 + 9, 1000)
    b = traffic.open_schedule(mix(name), 3.0, 20.0, 40.0, 2 ** 31 + 9, 1000)
    c = traffic.open_schedule(mix(name), 3.0, 20.0, 40.0, 5, 1000)
    assert [(p.due_s, p.max_new) for p in a] == [(p.due_s, p.max_new)
                                                 for p in b]
    assert all(np.array_equal(p.prompt, q.prompt) for p, q in zip(a, b))
    assert [p.due_s for p in a] != [p.due_s for p in c]


@pytest.mark.parametrize("name", ["chat", "rag"])
def test_every_seed_gets_the_same_window(name):
    """The requests due in the window: one count, one set of lengths, and
    in each block one set of gaps (the bursts stay where the mix's pattern
    puts them) for every seed, in another order."""
    m = mix(name)
    seen = []
    for seed in (1, 2, 2 ** 31 + 5):
        plan = [p for p in traffic.open_schedule(m, 3.2, 25.0, 40.0, seed,
                                                 1000) if p.due_s >= 25.0]
        due = np.array([p.due_s for p in plan])
        gaps = np.diff(due, prepend=due[0] - 2 * (due[0] - 25.0))
        k = traffic.REORDER_BLOCK
        blocks = [sorted(np.round(gaps[i:i + k], 9)) for i in range(0, 128, k)]
        seen.append((len(plan), sorted(len(p.prompt) for p in plan),
                     sorted(p.max_new for p in plan), blocks))
        assert len(plan) == 128 and max(due) < 65.0
    assert seen[0][:3] == seen[1][:3] == seen[2][:3]
    assert all(np.allclose(a, b) for x in seen[1:]
               for a, b in zip(seen[0][3], x[3]))
    assert collections.Counter(seen[0][1]) == collections.Counter(
        traffic.length_quantiles(m["prompt_len"], 128).tolist())


def test_open_schedule_keeps_its_rate_and_bounds():
    m = mix("chat")
    plan = traffic.open_schedule(m, 4.0, 25.0, 300.0, 17, 50)
    assert len(plan) == 100 + 1200
    assert all(0 < p.due_s < 325.0 for p in plan)
    assert sorted(p.due_s for p in plan) == [p.due_s for p in plan]
    assert all(16 <= len(p.prompt) <= 1024 and 16 <= p.max_new <= 512
               for p in plan)
    assert all(int(p.prompt.max()) < 50 for p in plan)
    gaps = np.diff([p.due_s for p in plan[100:]])
    assert abs(statistics.mean(gaps) - 0.25) < 0.01   # exponential, 1/rate
    assert abs(statistics.stdev(gaps) - 0.25) < 0.03


def test_length_distributions():
    chat = mix("chat")
    p = traffic.length_quantiles(chat["prompt_len"], 1001)
    assert statistics.median(p.tolist()) == 256
    assert p.min() >= 16 and p.max() == 1024     # the tail is clipped
    o = traffic.length_quantiles(chat["output_len"], 1001)
    assert statistics.median(o.tolist()) == 160
    rag = traffic.length_quantiles(mix("rag")["prompt_len"], 1920)
    assert rag.min() == 2048 and rag.max() == 3968
    assert len(set(rag.tolist())) == 1920          # every length once
    assert (traffic.length_quantiles({"dist": "fixed", "value": 7}, 3)
            == 7).all()


def test_closed_batches():
    m = mix("longdoc")
    a, b = (traffic.ClosedBatches(m, 2 ** 33, 100) for _ in range(2))
    x, y = a.next(), b.next()
    assert x.shape == (16, 2040) and a.new == 8
    assert np.array_equal(x, y) and not np.array_equal(x, a.next())
