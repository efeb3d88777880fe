"""PyTorch port: the trace of tests/test_torch_partitions.py at block48 on
the per-ray stack path, in a file of its own: it is that module's slowest
case."""

from __future__ import annotations

import pytest

from test_torch_partitions import check_partition_trace
from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("partition, path", [("block48", "stack")])
def test_partition_trace_matches_jax(partition, path):
    check_partition_trace(partition, path)
