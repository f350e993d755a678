"""The traffic generator: a job is a seed-drawn order of the pool."""
import itertools

import pytest

from evcbench import spec, traffic

MIX = spec.load_json(spec.HERE / "traffic" / "pool_jobs.json")


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**31 + 17, 2**33 + 5])
def test_each_job_is_a_permutation_of_the_pool(seed):
    jobs = list(itertools.islice(traffic.job_orders(MIX, 8, seed), 5))
    for j in jobs:
        assert sorted(j) == list(range(8))
    again = list(itertools.islice(traffic.job_orders(MIX, 8, seed), 5))
    assert jobs == again


def test_seeds_draw_other_orders():
    a = next(traffic.job_orders(MIX, 8, 1))
    b = next(traffic.job_orders(MIX, 8, 2))
    assert a != b


def test_a_job_larger_than_the_pool_is_refused():
    with pytest.raises(ValueError):
        next(traffic.job_orders(MIX, 4, 1))


def test_a_key_that_nothing_reads_is_refused():
    assert traffic.check(dict(MIX)) == MIX
    with pytest.raises(ValueError):
        traffic.check({**MIX, "callers": 4})
    with pytest.raises(ValueError):
        traffic.check({"gops_per_job": 8})
