"""PyTorch port: `output/` (the port's copies of the JAX package's PNG
writer, encoders and live previews): a written PNG reads back, its bytes are
those the JAX package writes for the same frame, and the HTTP live view
serves, stops and follows a progressive render through the port's renderer
(mirrors of tests/test_http_preview.py, on loopback)."""

from __future__ import annotations

import io
import urllib.request

import numpy as np
import pytest

from hslu_i.ba_raytracing.f2501_raytracer_tpu.framebuffer import ImageBuffer as JaxImageBuffer
from hslu_i.ba_raytracing.f2501_raytracer_tpu.output import FileOutput as JaxFileOutput
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch import (
    ImageBuffer,
    RaytracerRenderer,
    RenderConfig,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.models import build
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.output import (
    FileColorEncoder,
    FileOutput,
    read_png,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.output.http_preview import (
    HttpPreview,
    RenderAborted,
)
from hslu_i.ba_raytracing.f2501_raytracer_tpu_torch.output.preview import TerminalPreview
from test_torch_renderer import one_torch_thread  # noqa: F401  (autouse)


def _buffer(cls, seed=2):
    rng = np.random.default_rng(seed)
    buf = cls(13, 7)
    buf.color[:] = rng.uniform(-0.1, 1.1, buf.color.shape).astype(np.float32)
    buf.valid[:] = rng.random(buf.valid.shape) < 0.8
    return buf


def test_png_round_trips_and_matches_jax_bytes(tmp_path):
    buf, jbuf = _buffer(ImageBuffer), _buffer(JaxImageBuffer)
    FileOutput(tmp_path / "port.png").render_buffer(buf)
    JaxFileOutput(tmp_path / "jax.png").render_buffer(jbuf)
    got = read_png(tmp_path / "port.png")
    np.testing.assert_array_equal(got, buf.as_u8())
    assert got.shape == (7, 13, 3) and got.max() > 0
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    px = FileColorEncoder.to_output(buf.as_linear())
    np.testing.assert_array_equal(FileColorEncoder.from_output(px), got / np.float32(255.0))


def test_terminal_preview_draws_and_writes_png(tmp_path):
    out = io.StringIO()
    pv = TerminalPreview(max_cols=8, fps=1000.0, png_path=tmp_path / "p.png", stream=out)
    buf = _buffer(ImageBuffer)
    pv(buf, 0.5)
    pv.finish(buf)
    assert "▀" in out.getvalue() and "100.0%" in out.getvalue()
    np.testing.assert_array_equal(read_png(tmp_path / "p.png"), buf.as_u8())


def test_preview_serves_frame_and_stops(tmp_path):
    pv = HttpPreview(title="t", fps=1000.0)
    url = pv.start()
    try:
        buf = ImageBuffer(8, 6)
        buf.commit_tile(0, 0, np.full((6, 8, 3), 0.5, np.float32), np.ones((6, 8), bool))
        pv(buf, 1.0)
        page = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "<title>t</title>" in page and "Escape" in page
        png = urllib.request.urlopen(url + "frame.png", timeout=10).read()
        (tmp_path / "f.png").write_bytes(png)
        img = read_png(tmp_path / "f.png")
        assert img.shape == (6, 8, 3) and img.max() > 0
        # Escape -> POST /stop -> the next callback raises (window-close exit)
        req = urllib.request.Request(url + "stop", method="POST", data=b"")
        urllib.request.urlopen(req, timeout=10)
        assert pv.stopped
        with pytest.raises(RenderAborted):
            pv(buf, 0.5)
    finally:
        pv.close()


def test_progressive_port_render_through_preview():
    cfg = RenderConfig(width=24, height=20, tile_rays=120)  # 4 tiles
    pv = HttpPreview(fps=1000.0)
    url = pv.start()
    try:
        buf = RaytracerRenderer(cfg, device="cpu").render(build("semesterbild", cfg),
                                                           progress=pv)
        pv.finish(buf)
        png = urllib.request.urlopen(url + "frame.png", timeout=10).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 100
        assert buf.valid.mean() > 0.5
    finally:
        pv.close()
