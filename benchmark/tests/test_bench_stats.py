"""The rate, the 95th percentile and the rule on canned per-pair results."""
import math

import numpy as np

from benchmark import stats

RULE = {"rot_rad": 0.05, "t_over_thr": 1.0}


def test_rate_counts_only_pairs_that_met_the_rule():
    assert stats.rate([True, True, False, True], 2.0) == 1.5


def test_p95_over_every_pair():
    times = [0.1 + 0.001 * i for i in range(100)]
    assert stats.p95(times, [True] * 100) == times[94]


def test_p95_counts_a_missed_pair_as_beyond_any_limit():
    times = [0.1] * 19 + [0.05]
    ok = [True] * 19 + [False]
    assert stats.p95(times, ok) == 0.1
    assert math.isinf(stats.p95(times[:10], [True] * 9 + [False]))


def test_rule():
    T = np.eye(4)
    assert stats.meets_rule(True, 0.01, 0.5, 1.0, RULE)
    assert not stats.meets_rule(False, 0.01, 0.5, 1.0, RULE)
    assert not stats.meets_rule(True, 0.06, 0.5, 1.0, RULE)
    assert not stats.meets_rule(True, 0.01, 1.5, 1.0, RULE)
    c, s = math.cos(0.3), math.sin(0.3)
    T2 = np.eye(4)
    T2[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T2[:3, 3] = [3.0, 4.0, 0.0]
    r, t = stats.rotation_translation_error(T, T2)
    assert abs(r - 0.3) < 1e-12 and abs(t - 5.0) < 1e-12
