"""The traced window's arithmetic on synthetic event lists: busy time as a
union of device intervals, launches, idle gaps, and kernel names."""

import pytest

import fb_util  # noqa: F401 (paths)
from framebench import roofline, tracing
from framebench.port import wrapper_of
from framebench.tracing import Event

K, R, C = "kernel", "runtime", "cpu"


def test_overlapping_kernels_count_once():
    evs = [Event("a", K, 1.0, 2.0), Event("b", K, 2.0, 2.0), Event("c", K, 10.0, 1.0)]
    assert tracing.busy_seconds(evs, (0.0, 20.0)) == pytest.approx(4.0)
    assert tracing.union_intervals([(1, 3), (2, 4), (10, 11)]) == [(1, 4), (10, 11)]


def test_kernel_under_its_aten_op_is_not_counted_twice():
    """The sum over key_averages counts a glue kernel under its `aten::` op
    and its kernel name; the union of device intervals does not."""
    evs = [Event("aten::mul", C, 1.0, 0.5), Event("cudaLaunchKernel", R, 1.1, 0.01),
           Event("elementwise_kernel", K, 1.2, 0.3)]
    assert tracing.busy_seconds(evs, (0.0, 2.0)) == pytest.approx(0.3)
    assert tracing.device_seconds_by_name(evs, (0.0, 2.0)) == {"elementwise_kernel": pytest.approx(0.3)}


def test_busy_time_is_clipped_to_the_window():
    evs = [Event("a", K, 0.5, 1.0), Event("Memcpy DtoH", "memcpy", 2.5, 1.0)]
    assert tracing.busy_seconds(evs, (1.0, 3.0)) == pytest.approx(1.0)


def test_launch_count_takes_graph_replays_as_one():
    evs = [Event("cudaLaunchKernel", R, 0, 1), Event("cudaLaunchKernel_ptsz", R, 0, 1),
           Event("cuLaunchKernel", R, 0, 1), Event("cudaLaunchKernelExC", R, 0, 1),
           Event("cudaGraphLaunch", R, 0, 1), Event("cudaMemcpyAsync", R, 0, 1),
           Event("aten::add", C, 0, 1), Event("cudaLaunchKernel", K, 0, 1)]
    assert tracing.launch_count(evs) == 5


def test_idle_gaps_are_named_by_the_innermost_host_event():
    evs = [Event("k1", K, 0.0, 1.0), Event("k2", K, 3.0, 1.0), Event("k3", K, 4.5, 0.5),
           Event("aten::item", C, 1.0, 2.5), Event("cudaMemcpyAsync", R, 1.5, 1.0)]
    gaps = tracing.idle_gaps(evs, (0.0, 6.0))
    assert gaps == {"cudaMemcpyAsync": pytest.approx(2.0),
                    "host, between operations": pytest.approx(1.5)}


def test_window_of_reads_the_mark():
    evs = [Event(tracing.WINDOW_MARK, "mark", 2.0, 3.0), Event("k", K, 0.0, 9.0)]
    assert tracing.window_of(evs) == (2.0, 5.0)


def test_kernel_names_map_to_their_wrappers():
    assert wrapper_of("void cast_triangles_kernel<true>(CastArgs)") == "cast_triangles"
    assert wrapper_of("cast_triangles_stream_kernel") == "cast_triangles_stream"
    assert wrapper_of("void shade_eval_rows_kernel<false, 1>(ShadeScene, float*)") == "shade_eval_rows"
    assert wrapper_of("shade_eval_lane_kernel") == "shade_eval"
    assert wrapper_of("void at::native::vectorized_elementwise_kernel<4>(int)") is None


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 134e12) == pytest.approx(2.0)
    assert roofline.roofline_pct("light_shade", [dict(device_s=None)]) is None


def test_window_without_a_mark_spans_device_and_runtime_events():
    evs = [Event("Activity Buffer Request", C, 0.0, 0.1), Event("cudaLaunchKernel", R, 1.0, 0.1),
           Event("k", K, 1.2, 0.5), Event("Memcpy DtoH", "memcpy", 2.0, 0.5)]
    assert tracing.window_of(evs) == (1.0, 2.5)
