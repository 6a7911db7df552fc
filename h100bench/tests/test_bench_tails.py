"""Tails are taken over every request, by nearest rank."""

import pytest

from h100bench.common import Check, tail


def test_nearest_rank():
    values = list(range(1, 201))  # 200 requests
    assert tail(values, 0.95) == 190  # ten values beyond it
    assert tail(values, 0.5) == 100
    assert tail([3.0], 0.95) == 3.0


def test_tail_keeps_every_value():
    slow = [0.1] * 180 + [5.0] * 20
    assert tail(slow, 0.95) == 5.0  # the slowest tenth is in the tail
    assert tail(sorted(slow, reverse=True), 0.95) == 5.0


def test_empty_tail_is_nan():
    assert tail([], 0.95) != tail([], 0.95)


@pytest.mark.parametrize("value,ok", [(0.5, True), (1.0, True), (1.5, False),
                                      (float("nan"), False), (float("inf"), False)])
def test_check_holds_a_number_to_its_limit(value, ok):
    assert Check("gap", value, 1.0).ok is ok
