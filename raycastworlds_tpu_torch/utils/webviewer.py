"""Browser-based interactive play for headless GPU hosts.

The port of the JAX package's ``utils/webviewer.py``.  The reference's
``play!`` needs a local display (a minifb window); remote GPU hosts usually
have none.  This module serves the play loop over HTTP instead: a
dependency-free stdlib server streams PNG frames to a browser page whose
key events drive the env with the reference key map (w/s/a/d -> actions
0-3, r = reset, v = toggle camera/top view, q = quit).

    python -m raycastworlds_tpu_torch.utils.webviewer --port 8000
    python -m raycastworlds_tpu_torch.utils.webviewer --device cpu
    # then open http://<host>:8000/ (or tunnel the port)

The env runs on its device (the CUDA device by default).  The HTTP handler
threads never touch it concurrently: every reset, step and render happens
under the session's lock, on the session's device; frames are re-rendered
only after the state changes.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import torch

from .viewer import ACTION_KEYS, default_env, png_bytes

_PAGE = """<!DOCTYPE html>
<html><head><title>raycastworlds_tpu_torch</title><style>
body { background:#111; color:#ddd; font-family:monospace; text-align:center }
img { image-rendering:pixelated; width:70vw; max-width:1024px; margin-top:2em;
      border:1px solid #444 }
#status { margin-top:1em }
</style></head><body>
<div>raycastworlds_tpu_torch — w/s/a/d move &amp; turn, r reset, v view, q quit</div>
<img id="view" src="/frame.png">
<div id="status"></div>
<script>
const img = document.getElementById('view');
const status = document.getElementById('status');
let seq = 0;
async function refresh() {
  img.src = '/frame.png?t=' + (++seq);
  const r = await fetch('/status');
  const s = await r.json();
  status.textContent = 'steps=' + s.steps + ' reward=' + s.reward +
                       ' done=' + s.done + ' view=' + s.view;
  if (s.quit) { status.textContent += '  (server stopped)'; }
}
document.addEventListener('keydown', async (e) => {
  const k = e.key.toLowerCase();
  if (!'wsadrvq'.includes(k)) return;
  await fetch('/key?k=' + k);
  await refresh();
});
refresh();
</script></body></html>
"""


class WebPlaySession:
    """Env-driving logic behind the HTTP server (kept separate so it can be
    exercised without sockets).  Mirrors the terminal/X11 ``play()`` loop:
    camera view by default, top view on 'v', reset on 'r'.  ``env=None``
    plays the viewer's default env on ``device``."""

    def __init__(self, env=None, seed: int = 0, device=None):
        from .. import rng

        if env is None:
            env = default_env(device)
        if getattr(env.game, "action_shape", ()) != ():
            raise ValueError(
                "WebPlaySession drives single-agent games (per-env action "
                "shape ()); MultiPlayerRoom needs a per-player action vector "
                "a browser key can't express"
            )
        self.env = env
        self.seed = seed
        self._lock = threading.Lock()
        with self._lock:
            self.state, _ = env.reset(rng.PRNGKey(seed))
        self.steps = 0
        self.view = 0  # 0 = camera, 1 = top
        self.quit = False
        self._frame_cache: Optional[bytes] = None

    def frame_png(self) -> bytes:
        with self._lock:
            if self._frame_cache is None:
                render = self.env.camera_view if self.view == 0 else self.env.top_view
                self._frame_cache = png_bytes(render(self.state)[0])
            return self._frame_cache

    def status(self) -> dict:
        with self._lock:
            return self._status()

    def _status(self) -> dict:
        return {
            "steps": self.steps,
            "reward": float(self.state.reward[0]),
            "done": bool(self.state.done[0]),
            "view": "camera" if self.view == 0 else "top",
            "quit": self.quit,
        }

    def handle_key(self, ch: str) -> dict:
        from .. import rng

        with self._lock:
            if ch == "q":
                self.quit = True
            elif ch == "r":
                self.state, _ = self.env.reset(rng.PRNGKey(self.seed + self.steps + 1))
                self.steps = 0
            elif ch == "v":
                self.view = 1 - self.view
            elif ch in ACTION_KEYS:
                a = torch.full((self.env.num_envs,), ACTION_KEYS.index(ch), dtype=torch.int32)
                self.state = self.env.step(self.state, a).state
                self.steps += 1
            else:
                return {"ok": False, "error": f"unknown key {ch!r}"}
            self._frame_cache = None
            return {"ok": True, **self._status()}


def _make_handler(session: WebPlaySession):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif url.path == "/frame.png":
                self._send(200, "image/png", session.frame_png())
            elif url.path == "/status":
                self._send(
                    200, "application/json",
                    json.dumps(session.status()).encode(),
                )
            elif url.path == "/key":
                q = parse_qs(url.query)
                ch = (q.get("k") or [""])[0]
                out = session.handle_key(ch)
                self._send(200, "application/json", json.dumps(out).encode())
            else:
                self._send(404, "text/plain", b"not found")

        def log_message(self, *a):  # quiet
            pass

    return Handler


class WebViewer:
    """HTTP server around a :class:`WebPlaySession`.  ``port=0`` binds an
    ephemeral port (see ``.port``)."""

    def __init__(self, env=None, seed: int = 0, host: str = "127.0.0.1",
                 port: int = 8000, device=None):
        self.session = WebPlaySession(env, seed, device)
        self._httpd = ThreadingHTTPServer(
            (host, port), _make_handler(self.session)
        )
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "WebViewer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def play_web(env=None, seed: int = 0, host: str = "127.0.0.1",
             port: int = 8000, device=None) -> None:
    """Serve the interactive play page until the browser sends 'q'."""
    import time

    viewer = WebViewer(env, seed, host, port, device).start()
    print(f"serving play page on http://{host}:{viewer.port}/  (q to quit)")
    try:
        while not viewer.session.quit:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        viewer.stop()


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="bind address (0.0.0.0 opt-in exposes unauthenticated env control)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the env (default: the CUDA device)")
    args = p.parse_args(argv)
    play_web(seed=args.seed, host=args.host, port=args.port, device=args.device)


if __name__ == "__main__":
    main()
