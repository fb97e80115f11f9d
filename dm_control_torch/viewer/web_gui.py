"""Web-canvas GUI backend for the interactive viewer (counterpart of
``dm_control_tpu/viewer/web_gui.py``).

The reference viewer opens a GLFW window (dm_control/viewer/gui/
glfw_gui.py:164); on a headless GPU machine or in a notebook the natural
"window" is a browser tab, so this backend serves the ray-cast frames over a
zero-dependency stdlib HTTP server and feeds mouse/keyboard events back
into the same InputMap the reference binds to GLFW callbacks.

    from dm_control_torch import viewer
    viewer.launch_web(lambda: suite.load("cartpole", "swingup"),
                      port=8000)

Controls (reference application.py key map): drag = orbit,
right-drag = pan, shift+right-drag = vertical pan, wheel = zoom,
ctrl+drag = drag selected body (perturbation), double-click = select,
space = pause, backspace = restart, [ / ] = cycle cameras.
"""

from __future__ import annotations

import json
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from dm_control_torch.viewer import user_input
from dm_control_torch.viewer import runtime as runtime_module
from dm_control_torch.viewer.viewer import Viewer, apply_perturbation


def png_encode(rgb: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (zlib + struct, no deps)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


#: the viewer's input bindings, surfaced by the help pane (the analogue
#: of the reference's HelpPane rows, dm_control/viewer/views.py:66-98)
HELP_BINDINGS = [
    ("drag", "orbit camera"),
    ("right-drag", "pan camera"),
    ("shift+right-drag", "vertical pan"),
    ("wheel", "zoom"),
    ("ctrl+drag", "drag selected body (perturbation)"),
    ("double-click", "select body"),
    ("space", "pause / resume"),
    ("backspace", "restart episode"),
    ("right arrow", "advance one step while paused"),
    ("[ / ]", "previous / next camera"),
    ("h or F1", "toggle this help pane"),
    ("s", "capture current frame (PNG download)"),
]

_PAGE = """<!DOCTYPE html>
<html><head><title>dm_control_torch viewer</title><style>
body { background:#111; color:#ddd; font-family:monospace; }
#view { border:1px solid #444; cursor:crosshair; }
#help { display:none; position:absolute; left:20px; top:60px;
        background:rgba(0,0,0,0.85); border:1px solid #666;
        padding:10px 16px; z-index:2; }
#help td { padding:1px 10px; }
#status td { padding:1px 10px; color:#9c9; }
</style></head><body>
<div>dm_control_torch viewer &mdash; press <b>h</b> for help,
<b>s</b> to capture a frame</div>
<div id="help"><b>Input bindings</b><table id="helprows"></table></div>
<img id="view" width="WIDTH" height="HEIGHT"/>
<table id="status"></table>
<script>
fetch('/help').then(r => r.json()).then(rows => {
  document.getElementById('helprows').innerHTML = rows.map(
    r => '<tr><td>' + r[0] + '</td><td>' + r[1] + '</td></tr>').join('');
});
function toggleHelp() {
  const el = document.getElementById('help');
  el.style.display = el.style.display === 'block' ? 'none' : 'block';
}
function capture() {
  const a = document.createElement('a');
  a.href = '/capture?' + Date.now();
  a.download = 'frame.png';
  a.click();
}
const img = document.getElementById('view');
let dragging = false, lastX = 0, lastY = 0, button = 0;
function post(ev) {
  fetch('/event', {method: 'POST', body: JSON.stringify(ev)});
}
function mods(e) {
  return (e.shiftKey ? 1 : 0) | (e.ctrlKey ? 2 : 0) | (e.altKey ? 4 : 0);
}
const BTN = ['MouseLeft', 'MouseMiddle', 'MouseRight'];
img.addEventListener('mousedown', e => {
  dragging = true; lastX = e.offsetX; lastY = e.offsetY; button = e.button;
  post({type: 'key', key: BTN[e.button], pressed: true, mods: mods(e)});
  e.preventDefault();
});
window.addEventListener('mouseup', e => {
  if (!dragging) return;
  dragging = false;
  post({type: 'key', key: BTN[e.button], pressed: false, mods: mods(e)});
});
img.addEventListener('mousemove', e => {
  if (!dragging) return;
  post({type: 'move', pos: [e.offsetX, e.offsetY],
        delta: [e.offsetX - lastX, e.offsetY - lastY]});
  lastX = e.offsetX; lastY = e.offsetY;
});
img.addEventListener('wheel', e => {
  post({type: 'scroll', value: e.deltaY > 0 ? -1 : 1});
  e.preventDefault();
});
img.addEventListener('dblclick', e => {
  post({type: 'dblclick', pos: [e.offsetX, e.offsetY]});
});
img.addEventListener('contextmenu', e => e.preventDefault());
window.addEventListener('keydown', e => {
  if (e.key === 'h' || e.key === 'F1') { toggleHelp(); return; }
  if (e.key === 's') { capture(); return; }
  post({type: 'key', key: e.key === ' ' ? ' ' : e.key, pressed: true,
        mods: mods(e)});
});
function refresh() {
  img.src = '/frame?' + Date.now();
}
img.onload = () => setTimeout(refresh, 40);
img.onerror = () => setTimeout(refresh, 500);
refresh();
setInterval(() => fetch('/status').then(r => r.json()).then(s => {
  document.getElementById('status').innerHTML = Object.entries(s).map(
    ([k, v]) => '<tr><td>' + k + '</td><td>' + v + '</td></tr>').join('');
}), 1000);
</script></body></html>
"""


class WebViewerServer:
    """Serves frames + routes events for a live env/policy loop."""

    def __init__(self, env, policy=None, width=480, height=360, port=0):
        from dm_control_torch.rendering.camera import MovableCamera

        self.env = env
        self.runtime = runtime_module.Runtime(env, policy)
        self.camera = MovableCamera(env.physics, height=height,
                                    width=width)
        n_fixed = int(getattr(env.physics.model, "ncam", 0))
        self.viewer = Viewer(self.camera, env.physics,
                             n_fixed_cameras=n_fixed)
        self.paused = False
        self._fps = 0.0
        self._last_tick = None
        self._lock = threading.Lock()
        self._frame_png = png_encode(np.zeros((height, width, 3),
                                              np.uint8))
        self._install_app_bindings()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame"):
                    self._send(200, "image/png", server._frame_png)
                elif self.path.startswith("/capture"):
                    # frame capture: same pixels, download semantics
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Disposition",
                                     "attachment; filename=frame.png")
                    self.send_header("Content-Length",
                                     str(len(server._frame_png)))
                    self.end_headers()
                    self.wfile.write(server._frame_png)
                elif self.path.startswith("/help"):
                    self._send(200, "application/json",
                               json.dumps(HELP_BINDINGS).encode())
                elif self.path.startswith("/status"):
                    self._send(200, "application/json",
                               json.dumps(server.status()).encode())
                else:
                    page = (_PAGE.replace("WIDTH", str(width))
                            .replace("HEIGHT", str(height)))
                    self._send(200, "text/html", page.encode())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                    server.handle_event(ev)
                except Exception:
                    pass
                self._send(200, "application/json", b"{}")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_address[1]

    # -- app controls ----------------------------------------------------------

    def _install_app_bindings(self):
        im = self.viewer.input_map
        im.bind(self.toggle_pause, user_input.KEY_SPACE)
        im.bind(self.runtime.restart, user_input.KEY_BACKSPACE)
        im.bind(self.runtime.single_step, user_input.KEY_RIGHT)

    def toggle_pause(self):
        self.paused = not self.paused

    def status(self):
        """Status-pane fields (the reference's ViewerStatus rows,
        dm_control/viewer/application.py:98-130)."""
        return {
            "state": self.runtime.state.name,
            "paused": self.paused,
            "sim_time": round(self.runtime.get_time(), 3),
            "selected_body": self.viewer.manipulator.selected_body,
            "camera": ("free" if self.viewer.camera_select.is_free
                       else self.viewer.camera_select.camera_id),
            "fps": round(self._fps, 1),
        }

    def handle_event(self, ev):
        with self._lock:
            t = ev.get("type")
            if t == "key":
                self.viewer.input_map.key_event(
                    ev["key"], bool(ev.get("pressed", True)),
                    int(ev.get("mods", 0)))
            elif t == "move":
                self.viewer.input_map.mouse_move(ev["pos"], ev["delta"])
            elif t == "scroll":
                self.viewer.input_map.scroll(float(ev["value"]))
            elif t == "dblclick":
                self.viewer.select_at(ev["pos"])

    # -- main loop --------------------------------------------------------------

    def tick(self, elapsed: float):
        """One display tick: perturb, step, render."""
        import time as _time

        now = _time.perf_counter()
        if self._last_tick is not None and now > self._last_tick:
            inst = 1.0 / (now - self._last_tick)
            self._fps = 0.9 * self._fps + 0.1 * inst if self._fps else inst
        self._last_tick = now
        with self._lock:
            pert = self.viewer.manipulator.perturbation_force
            if pert is not None:
                apply_perturbation(self.env, pert[0], pert[1])
            self.runtime.tick(elapsed, self.paused)
            if self.viewer.camera_select.is_free:
                frame = self.camera.render()
            else:
                frame = self.env.physics.render(
                    height=self.camera.height, width=self.camera.width,
                    camera_id=self.viewer.camera_select.camera_id)
            self._frame_png = png_encode(np.asarray(frame))

    def serve_forever(self, fps=25.0, max_seconds=None):
        import time

        thread = threading.Thread(target=self.httpd.serve_forever,
                                  daemon=True)
        thread.start()
        print(f"[viewer] serving on http://127.0.0.1:{self.port}")
        t0 = time.perf_counter()
        frame_dt = 1.0 / fps
        try:
            while True:
                t = time.perf_counter()
                self.tick(frame_dt)
                if max_seconds and t - t0 > max_seconds:
                    break
                sleep = frame_dt - (time.perf_counter() - t)
                if sleep > 0:
                    time.sleep(sleep)
                if self.runtime.state == runtime_module.State.STOPPED:
                    self.runtime.restart()
        finally:
            self.httpd.shutdown()


def launch(environment_loader, policy=None, width=480, height=360,
           port=8000, fps=25.0, max_seconds=None):
    """Launches the web viewer on a live environment."""
    env = (environment_loader() if callable(environment_loader)
           else environment_loader)
    server = WebViewerServer(env, policy, width=width, height=height,
                             port=port)
    server.serve_forever(fps=fps, max_seconds=max_seconds)
    return server
