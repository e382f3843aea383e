"""Live viewer: an in-process HTTP/MJPEG server streaming the tracking
overlays while a run is in flight.

A copy of ``pointslot_tpu/viz/live.py`` for the port's runner
(``python -m pointslot_torch.run ... --live PORT``), with one departure:
the page's CSS reads ``max-width:100%``. The JAX page is a bytes literal
that is never %-formatted, so it serves a doubled percent sign, which
browsers drop. It encodes through PIL, as the JAX module does.

The JAX module's description follows.

The reference's Viewer is a Pangolin OpenGL loop on its own thread
(reference src/Viewer.cc:62, spawned at src/System.cc:120-125) — a
windowing stack a TPU host usually doesn't have. The TPU-native
equivalent keeps the same role (watch keypoints/boxes/cuboids + the
top-down map live, at a throttled rate, off the tracking thread) but
serves it over HTTP so any browser on the network is the display:

    python -m pointslot_torch.run --synthetic 60 --mode 4 --live 8765
    # open http://<host>:8765/

Endpoints: `/` (HTML page with both views), `/stream` (MJPEG
multipart), `/frame.png` (latest overlay), `/map.png` (latest top-down
map). Everything is stdlib http.server + PIL; frames are pushed by the
run loop via `push_frame`/`push_map` and the newest one wins — a slow
client never backpressures tracking (the reference throttles its GL
loop the same way, Viewer.cc frame-rate lock).
"""

from __future__ import annotations

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = b"""<!doctype html><html><head><title>pointslot_torch live</title>
<style>body{background:#111;color:#ddd;font-family:monospace;margin:14px}
img{image-rendering:pixelated;max-width:100%}</style></head>
<body><h3>pointslot_torch live</h3>
<div><img src="/stream" alt="frame stream"></div>
<div><img src="/map.png" id="map" alt="top-down map" width="480"></div>
<script>setInterval(()=>{document.getElementById('map').src=
'/map.png?'+Date.now();}, 1000);</script>
</body></html>"""


def _encode_jpeg(img: np.ndarray, quality: int = 80) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(img, np.uint8)).save(
        buf, "JPEG", quality=quality)
    return buf.getvalue()


def _encode_png(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(img, np.uint8)).save(buf, "PNG")
    return buf.getvalue()


class LiveViewer:
    """Background HTTP server; `push_frame(img)` from the run loop."""

    def __init__(self, port: int = 8765, host: str = "0.0.0.0"):
        self._lock = threading.Lock()
        self._frame_jpeg: Optional[bytes] = None
        self._frame_png: Optional[bytes] = None
        self._map_png: Optional[bytes] = None
        self._new_frame = threading.Condition(self._lock)
        self._closed = False

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _send(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(_PAGE, "text/html")
                elif path == "/frame.png":
                    with viewer._lock:
                        body = viewer._frame_png
                    self._send(body or _encode_png(
                        np.zeros((8, 8), np.uint8)), "image/png")
                elif path == "/map.png":
                    with viewer._lock:
                        body = viewer._map_png
                    self._send(body or _encode_png(
                        np.zeros((8, 8), np.uint8)), "image/png")
                elif path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    try:
                        while not viewer._closed:
                            with viewer._new_frame:
                                viewer._new_frame.wait(timeout=1.0)
                                body = viewer._frame_jpeg
                            if body is None:
                                continue
                            self.wfile.write(b"--frame\r\n")
                            self.wfile.write(
                                b"Content-Type: image/jpeg\r\n\r\n")
                            self.wfile.write(body)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def push_frame(self, img: np.ndarray):
        """Publish the latest overlay (H, W[, 3]) uint8; newest wins."""
        jpeg = _encode_jpeg(img)
        png = _encode_png(img)
        with self._new_frame:
            self._frame_jpeg = jpeg
            self._frame_png = png
            self._new_frame.notify_all()

    def push_map(self, img: np.ndarray):
        png = _encode_png(img)
        with self._lock:
            self._map_png = png

    def close(self):
        self._closed = True
        with self._new_frame:
            self._new_frame.notify_all()
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
