"""PyTorch port: the traced cases of tests/test_torch_stream_trace.py on the
per-ray stack path (compaction_ratio 1), in a file of their own: their
shared reference trace is the slowest part of that module."""

from __future__ import annotations

import pytest

from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)
from test_torch_stream_trace import (  # noqa: F401 (collected here on this `traced`)
    test_streamed_paths_take_the_plain_node,
    test_streamed_trace_matches_jax,
    test_streamed_trace_matches_resident_trace,
    trace_path,
)


@pytest.fixture(scope="module", params=["stack"])
def traced(request):
    return trace_path(request.param)
