import itertools
from collections import Counter

import numpy as np
import pytest

from benchmark import spec, traffic


def _mix():
    return spec.cell("add_c2.xla.exit70")["traffic"]


@pytest.mark.parametrize("seed", (0, 1, 2 ** 31 + 5, 2 ** 40 + 1))
def test_every_block_sends_seven_early_of_ten(seed):
    reqs = list(itertools.islice(traffic.requests(_mix(), np.random.default_rng(seed)), 200))
    for b in range(20):
        block = reqs[10 * b:10 * b + 10]
        assert sum(r.early for r in block) == 7
        assert all(r.threshold == (1e9 if r.early else -1e9) for r in block)
    assert [r.index for r in reqs] == list(range(200))


def test_seed_orders_the_same_work():
    a = list(itertools.islice(traffic.requests(_mix(), np.random.default_rng(1)), 160))
    b = list(itertools.islice(traffic.requests(_mix(), np.random.default_rng(1)), 160))
    c = list(itertools.islice(traffic.requests(_mix(), np.random.default_rng(2)), 160))
    assert a == b and a != c
    # every pass over the pool of 16 visits each image once
    assert all(Counter(r.image for r in a[16 * p:16 * p + 16]) == Counter(range(16)) for p in range(10))
    assert Counter(r.early for r in a) == Counter(r.early for r in c)
