"""PyTorch port: the streamed pool-path frame of
tests/test_torch_stream_trace.py, in a file of its own: it is that
module's slowest case."""

from __future__ import annotations

import pytest

from test_torch_renderer import one_torch_thread  # noqa: F401 (autouse)
from test_torch_stream_trace import check_streamed_frame


@pytest.mark.parametrize("path", ["pool"])
def test_streamed_frame_matches_jax_and_resident(path):
    check_streamed_frame(path)
