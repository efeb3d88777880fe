"""Interactive live render view over HTTP — the display-server-free window.

The reference opens a minifb window that re-blits the shared framebuffer at
a 60 fps cap, scales it FitScreen, titles it with the feature banner, and
polls Escape to close (ref src/output/window.rs:31-100, output/mod.rs:91-101).
This environment has no display server, so the window is a browser tab:

* `GET /`          — the "window": fit-screen-scaled <img>, title = the
                     feature banner, JS re-fetches the frame at an fps cap,
                     Escape keydown posts /stop (the reference's close key)
* `GET /frame.png` — the CURRENT partially-rendered frame (producer/consumer:
                     the render thread commits tiles, viewers poll)
* `POST /stop`     — sets `stopped`; the render loop's progress callback
                     raises RenderAborted, mirroring the window-closed exit

Usage:
    preview = HttpPreview(title=feature_banner(cfg))
    url = preview.start()          # serves on 127.0.0.1:<port>
    renderer.render(scene, progress=preview)   # updates frames, honors stop
    preview.finish(buf)            # final frame; server keeps serving
    preview.close()
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..framebuffer import ImageBuffer
from .png_io import png_bytes

_PAGE = """<!doctype html>
<html><head><title>{title}</title><style>
 html,body {{ margin:0; height:100%; background:#111; }}
 img {{ width:100%; height:100%; object-fit:contain; image-rendering:pixelated; }}
</style></head><body>
<img id="f" src="/frame.png">
<script>
 const fps = {fps};
 const img = document.getElementById('f');
 setInterval(() => {{ img.src = '/frame.png?' + Date.now(); }}, 1000 / fps);
 document.addEventListener('keydown', e => {{
   if (e.key === 'Escape') fetch('/stop', {{method: 'POST'}});
 }});
</script></body></html>"""


class RenderAborted(RuntimeError):
    """Raised by the progress callback when the viewer pressed Escape."""


class HttpPreview:
    """Progress callback serving the live frame over HTTP.

    title — the window title (the reference uses the feature banner)
    fps   — client refresh cap (the reference caps its blit loop at 60)
    port  — 0 picks a free port
    """

    def __init__(self, title: str = "raytracer", fps: float = 30.0,
                 host: str = "127.0.0.1", port: int = 0):
        self.title = title
        self.fps = fps
        self.host = host
        self.port = port
        self.stopped = False
        self._frame = png_bytes(np.zeros((2, 2, 3), np.uint8))
        self._lock = threading.Lock()
        self._server = None
        self._thread = None
        self._min_dt = 1.0 / fps
        self._last = 0.0

    # -- server ------------------------------------------------------------
    def start(self) -> str:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.split("?")[0] == "/frame.png":
                    with outer._lock:
                        body = outer._frame
                    ctype = "image/png"
                else:
                    body = _PAGE.format(
                        title=outer.title, fps=outer.fps
                    ).encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path == "/stop":
                    outer.stopped = True
                self.send_response(204)
                self.end_headers()

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/"

    def close(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    # -- producer side -----------------------------------------------------
    def __call__(self, buf: ImageBuffer, frac: float):
        """Renderer progress callback: rate-limited re-encode of the partial
        frame; raises RenderAborted after the viewer pressed Escape."""
        if self.stopped:
            raise RenderAborted("stopped from the live view (Escape)")
        now = time.monotonic()
        if frac < 1.0 and now - self._last < self._min_dt:
            return
        self._last = now
        self._set(buf)

    def finish(self, buf: ImageBuffer):
        self._set(buf)

    def _set(self, buf: ImageBuffer):
        data = png_bytes(buf.as_u8())
        with self._lock:
            self._frame = data
