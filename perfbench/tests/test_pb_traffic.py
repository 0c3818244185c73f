"""The traffic generator: a seed fixes the trace; seeds share the sizes."""
import numpy as np
import pytest

from conftest import BURST_MIX, DECODE_MIX, SERVE_MIX, TRAIN_MIX
from perfbench.lib import spec, traffic


def _trace(plan):
    return [(b.due, [(r.rid, r.max_new, r.prefix_rank, r.tokens.tolist())
                     for r in b.requests]) for b in plan]


def test_same_seed_same_trace():
    a = traffic.serve_plan(SERVE_MIX, 2 ** 33 + 5, 2.0, 10.0, 400)
    b = traffic.serve_plan(SERVE_MIX, 2 ** 33 + 5, 2.0, 10.0, 400)
    assert _trace(a) == _trace(b)
    c = traffic.serve_plan(SERVE_MIX, 2 ** 33 + 6, 2.0, 10.0, 400)
    assert _trace(a) != _trace(c)


@pytest.mark.parametrize("mix", [BURST_MIX])
def test_seeds_share_sizes_and_gaps(mix):
    m = mix
    plans = [traffic.serve_plan(m, s, 1.4, 30.0, 250000) for s in (1, 99)]
    shapes = [(sorted((len(r.tokens), r.prefix_rank)
                      for b in p for r in b.requests),
               sorted(r.max_new for b in p for r in b.requests))
              for p in plans]
    gaps = [sorted(np.round(np.diff([b.due for b in p] + [30.0]), 9))
            for p in plans]
    assert shapes[0] == shapes[1]
    assert gaps[0] == gaps[1]
    assert all(b.due < 30.0 for p in plans for b in p)
    assert len(plans[0]) == 44          # round(1.4 * 30) to runs of 4


def test_runs_of_gaps_and_bursts_are_stratified():
    m = BURST_MIX
    plan = traffic.serve_plan(m, 3, 0.4, 50.0, 250000)
    assert len(plan) == 20
    gaps = list(np.diff([b.due for b in plan] + [50.0]))
    qs = sorted(gaps)
    for i in range(0, 20, 4):
        ranks = sorted(qs.index(g) // 5 for g in gaps[i:i + 4])
        assert ranks == [0, 1, 2, 3]
    outs = sorted(r.max_new for b in plan for r in b.requests)
    for b in plan:
        # one output of each eighth of the outputs
        eighths = sorted(outs.index(r.max_new) * 8 // len(outs)
                         for r in b.requests)
        assert eighths == sorted(eighths) and max(eighths) >= 6
    other = traffic.serve_plan(m, 4, 0.4, 50.0, 250000)
    rot = [round(g, 9) for g in np.diff([b.due for b in other] + [50.0])]
    mine = [round(g, 9) for g in gaps]
    assert any(mine[k:] + mine[:k] == rot for k in range(20))


def test_shared_prefixes_are_shared():
    m = BURST_MIX
    plan = traffic.serve_plan(m, 7, 1.4, 30.0, 250000)
    reqs = [r for b in plan for r in b.requests]
    share = sum(r.prefix_rank >= 0 for r in reqs) / len(reqs)
    assert abs(share - m["prefixes"]["share"]) < 0.01
    for r in reqs:
        assert m["prompt"]["min"] <= len(r.tokens) <= m["prompt"]["max"]
        assert 0 <= r.tokens.min() and r.tokens.max() < 250000
        if r.prefix_rank >= 0:
            L = m["prefixes"]["lengths"][r.prefix_rank]
            first = next(q for q in reqs if q.prefix_rank == r.prefix_rank)
            assert (r.tokens[:L] == first.tokens[:L]).all()
            assert len(r.tokens) >= L + m["prefixes"]["min_suffix"]
    counts = [sum(r.prefix_rank == k for r in reqs)
              for k in range(len(m["prefixes"]["lengths"]))]
    assert counts == sorted(counts, reverse=True)     # Zipf: hottest first


def test_stratified_median():
    d = {"dist": "lognormal", "median": 1536, "sigma": 0.5, "min": 256,
         "max": 3968}
    xs = traffic.stratified(d, 401)
    assert xs[200] == 1536 and xs == sorted(xs)
    assert min(xs) >= 256 and max(xs) <= 3968


def test_decode_pool_fits_capacity():
    pool = traffic.decode_pool(spec.traffic("decode_closed"), 5, 256000, 4096)
    assert len(pool) == 64
    assert all(len(s.tokens) + s.max_new < 4096 for s in pool)
    again = traffic.decode_pool(spec.traffic("decode_closed"), 5, 256000,
                                4096)
    assert [s.tokens.tolist() for s in pool] == \
        [s.tokens.tolist() for s in again]
    small = traffic.decode_pool(DECODE_MIX, 5, 512, 96)
    assert all(len(s.tokens) + s.max_new < 96 for s in small)


def test_train_rows_distinct_and_seeded():
    a = traffic.train_tokens(TRAIN_MIX, 2 ** 32 + 3, 512)
    b = traffic.train_tokens(TRAIN_MIX, 2 ** 32 + 3, 512)
    assert a.shape == (4, 4, 17) and (a == b).all()
    rows = a.reshape(-1, 17)
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
