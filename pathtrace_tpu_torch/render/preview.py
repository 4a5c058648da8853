"""Live preview: a local HTTP viewer of the progressive loop (counterpart
of ``pathtrace_tpu/render/preview.py``).

The reference's display is a GL window fed by a render worker thread;
here it is the browser. The render loop publishes each accumulated
frame's tensor by REFERENCE (:meth:`PreviewServer.update`, no copy, no
sync); the device-to-host copy and the PNG encode run lazily in the
HTTP handler thread when the page fetches ``/frame.png``, once per frame
(cached), and the page refreshes itself.

Endpoints:
  /            viewer page (auto-refreshing <img> and a stats line)
  /frame.png   the latest accumulated frame as PNG (sRGB, flipped)
  /stats.json  frame counter, Mrays/s and image size

Publishing a reference is safe only while the loop never writes into a
published tensor in place. It does not: ``render/frame.accumulate``
returns a new tensor every frame and the first frame's image is never
touched again, so a published frame stays as it was while the handler
reads it. The handler's ``.cpu()`` is enqueued on the handler thread's
current stream, the legacy default stream, so on a card a fetch lands
between two of the loop's kernels and reads the frame it names; a frame
nobody fetches costs the loop nothing.

Stdlib only: ``http.server`` on a daemon thread.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from pathtrace_tpu_torch.render import film

_PAGE = b"""<!doctype html>
<html><head><title>pathtrace_tpu_torch</title><style>
  body { background: #111; color: #ddd; font-family: monospace; text-align: center; }
  img  { image-rendering: pixelated; max-width: 95vw; max-height: 85vh;
         border: 1px solid #444; margin-top: 1em; }
</style></head><body>
<div id="stats">waiting for first frame...</div>
<img id="frame" src="/frame.png">
<script>
  const img = document.getElementById('frame');
  const stats = document.getElementById('stats');
  async function tick() {
    try {
      const r = await fetch('/stats.json');
      const s = await r.json();
      stats.textContent = `frame ${s.frame}  ${s.mrays_per_s.toFixed(2)} Mrays/s  ${s.width}x${s.height}`;
      img.src = '/frame.png?f=' + s.frame;
    } catch (e) {}
    setTimeout(tick, 500);
  }
  tick();
</script></body></html>"""


def _to_numpy(img) -> np.ndarray:
    if hasattr(img, "detach"):  # a torch tensor, on any device
        return img.detach().cpu().numpy()
    return np.asarray(img)


class PreviewServer:
    """Serves the latest accumulated frame; updated from the render loop.
    ``port=0`` takes an ephemeral port (:attr:`url` names it)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lock = threading.Lock()
        self._png: bytes = film.encode_png(np.zeros((2, 2, 3), np.uint8))
        self._png_frame = -1
        self._latest = None  # the published tensor (or array)
        self._stats = {"frame": 0, "mrays_per_s": 0.0, "width": 0, "height": 0}
        self.encodes = 0     # frames read back and encoded (handler thread)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                path = self.path.split("?")[0]
                if path in ("/", "/index.html"):
                    body, ctype = _PAGE, "text/html"
                elif path == "/frame.png":
                    body, ctype = outer._frame_png(), "image/png"
                elif path == "/stats.json":
                    with outer._lock:
                        body = json.dumps(outer._stats).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # no per-request stderr lines
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def update(self, img_linear, frame: int, mrays_per_s: float = 0.0) -> None:
        """Publish an accumulated frame (linear [H, W, 3]; a tensor on any
        device, or an array) by reference. The caller must not write into
        it afterwards."""
        with self._lock:
            self._latest = img_linear
            self._stats = {
                "frame": int(frame),
                "mrays_per_s": float(mrays_per_s),
                "width": int(img_linear.shape[1]),
                "height": int(img_linear.shape[0]),
            }

    def _frame_png(self) -> bytes:
        """The latest frame as PNG: read back and encoded once per frame,
        outside the lock, on the handler thread."""
        with self._lock:
            latest = self._latest
            frame = self._stats["frame"]
            if latest is None or self._png_frame == frame:
                return self._png
        arr = _to_numpy(latest)
        png = film.encode_png(film.to_srgb_u8(arr[::-1]), compress_level=1)
        with self._lock:
            self.encodes += 1
            if frame >= self._png_frame:
                self._png = png
                self._png_frame = frame
        return png

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
