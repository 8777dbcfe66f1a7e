"""Host-side frame viewing and the interactive play loop.

The port of the JAX package's ``utils/viewer.py``, with its own copy of
the loader and writers.  The reference's `play!` opens a minifb window with
a keyboard callback (its only native dependency).  GPU hosts are often
headless, so the equivalent here is:

* the native C++ viewer (native/viewer.cpp, loaded via ctypes): PPM writer +
  ANSI half-block compositor + frame differ, with pure-NumPy fallbacks when
  the shared library is not built;
* ``play()``: terminal-interactive play with the reference's key map
  (w/s/a/d -> actions 0-3, r = reset, v = toggle camera/top view, q = quit;
  ``get_action_keys``/``get_action_names``) rendering frames as ANSI
  half-blocks, or into an X11 window where there is a display.

The env renders on its device (the CUDA device by default); each shown
frame is copied to the host once.
"""

from __future__ import annotations

import ctypes
import os
import sys
import zlib
import struct
from typing import Optional

import numpy as np
import torch

from . import to_numpy

_LIB = None
_LIB_TRIED = False


def _native_lib() -> Optional[ctypes.CDLL]:
    """Load (and lazily build, with ``native/Makefile``) the native viewer
    library ``native/libviewer.so`` of the repo."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    so = os.path.join(root, "native", "libviewer.so")
    mk = os.path.join(root, "native", "Makefile")
    src = os.path.join(root, "native", "viewer.cpp")
    stale = os.path.exists(so) and os.path.exists(src) and (
        os.path.getmtime(src) > os.path.getmtime(so)
    )
    if (not os.path.exists(so) or stale) and os.path.exists(mk):
        import subprocess

        try:
            subprocess.run(
                ["make", "-C", os.path.dirname(mk)],
                check=True,
                capture_output=True,
                timeout=60,
            )
        except Exception:
            if not os.path.exists(so):
                return None
    if os.path.exists(so):
        lib = ctypes.CDLL(so)
        lib.rcw_write_ppm.restype = ctypes.c_int
        lib.rcw_write_ppm.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.rcw_ansi_render.restype = ctypes.c_long
        lib.rcw_ansi_render.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        lib.rcw_frame_diff.restype = ctypes.c_long
        lib.rcw_frame_diff.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_long,
        ]
        if hasattr(lib, "rcw_window_open"):  # X11 backend (viewer.cpp)
            lib.rcw_window_available.restype = ctypes.c_int
            lib.rcw_window_open.restype = ctypes.c_void_p
            lib.rcw_window_open.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.rcw_window_update.restype = ctypes.c_int
            lib.rcw_window_update.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.rcw_window_poll_key.restype = ctypes.c_int
            lib.rcw_window_poll_key.argtypes = [ctypes.c_void_p]
            lib.rcw_window_close.restype = None
            lib.rcw_window_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class Window:
    """A real X11 window for live frames, the equivalent of the reference's
    minifb window.

    ``Window.open()`` returns None on headless hosts (no $DISPLAY, no libX11,
    display refused) so callers can fall back to the terminal path.
    """

    def __init__(self, handle, h: int, w: int):
        self._handle = handle
        self._h = h
        self._w = w

    @staticmethod
    def available() -> bool:
        lib = _native_lib()
        return bool(
            lib is not None
            and hasattr(lib, "rcw_window_available")
            and lib.rcw_window_available()
        )

    @classmethod
    def open(cls, title: str, h: int, w: int) -> Optional["Window"]:
        lib = _native_lib()
        if lib is None or not hasattr(lib, "rcw_window_open"):
            return None
        handle = lib.rcw_window_open(title.encode(), int(w), int(h))
        if not handle:
            return None
        return cls(handle, h, w)

    def update(self, img) -> None:
        """Blit a u32 [H, W] frame (must match the open size)."""
        a = _as_u32(img)
        if a.shape != (self._h, self._w):
            raise ValueError(f"frame {a.shape} != window {(self._h, self._w)}")
        _native_lib().rcw_window_update(
            self._handle,
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self._h,
            self._w,
        )

    def poll_key(self) -> Optional[str]:
        """Next pressed key as a 1-char string, "close" if the WM closed the
        window, or None if nothing is pending."""
        k = _native_lib().rcw_window_poll_key(self._handle)
        if k == -1:
            return None
        if k == -2:
            return "close"
        return chr(k) if 0 < k < 0x110000 else None

    def close(self) -> None:
        if self._handle:
            _native_lib().rcw_window_close(self._handle)
            self._handle = None


def _as_u32(img) -> np.ndarray:
    a = np.ascontiguousarray(to_numpy(img).astype(np.uint32, copy=False))
    if a.ndim != 2:
        raise ValueError(f"expected [H, W] u32 frame, got {a.shape}")
    return a


def save_ppm(path: str, img) -> None:
    """Write a 0x00RRGGBB frame as binary PPM (native fast path)."""
    a = _as_u32(img)
    lib = _native_lib()
    if lib is not None:
        rc = lib.rcw_write_ppm(
            path.encode(),
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            a.shape[0],
            a.shape[1],
        )
        if rc == 0:
            return
    from ..colors import u32_to_rgb

    rgb = u32_to_rgb(a)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        f.write(rgb.tobytes())


def png_bytes(img) -> bytes:
    """Encode a u32 [H, W] frame as PNG bytes (dependency-free, 8-bit RGB)."""
    from ..colors import u32_to_rgb

    a = _as_u32(img)
    rgb = u32_to_rgb(a)
    h, w = a.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def save_png(path: str, img) -> None:
    """Minimal dependency-free PNG writer (8-bit RGB)."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def ansi_frame(img, max_width: int = 160) -> str:
    """Render a u32 frame as a 24-bit-color ANSI half-block string
    (2 vertical pixels per character row).  Downsamples to ``max_width``."""
    a = _as_u32(img)
    h, w = a.shape
    if w > max_width:
        f = (w + max_width - 1) // max_width
        a = np.ascontiguousarray(a[:: f, :: f])
        h, w = a.shape
    lib = _native_lib()
    if lib is not None:
        cap = (h // 2 + 1) * (w + 1) * 64 + 64
        buf = ctypes.create_string_buffer(cap)
        n = lib.rcw_ansi_render(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), h, w, buf, cap
        )
        if n >= 0:
            return buf.raw[:n].decode()
    # NumPy fallback
    lines = []
    for i in range(0, h - 1, 2):
        parts = []
        for j in range(w):
            t, b = int(a[i, j]), int(a[i + 1, j])
            parts.append(
                f"\x1b[38;2;{(t>>16)&255};{(t>>8)&255};{t&255}m"
                f"\x1b[48;2;{(b>>16)&255};{(b>>8)&255};{b&255}m▀"
            )
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines) + "\n"


ACTION_KEYS = ("w", "s", "a", "d")  # the reference's get_action_keys


def default_env(device=None):
    """The play loops' env: SingleRoom at 128 rays x 128 px, one env."""
    import raycastworlds_tpu_torch as rt

    return rt.Env(
        rt.SingleRoom(rt.EnvConfig(num_rays=128, height_camera_view_pu=128)),
        num_envs=1, device=device,
    )


def _actions(env, a: int) -> torch.Tensor:
    return torch.full((env.num_envs,), a, dtype=torch.int32)


def play(env=None, seed: int = 0, max_width: int = 128, out=sys.stdout,
         window: Optional[bool] = None, device=None):
    """Interactive play (the reference's ``play!``).

    Keys: w/s/a/d = forward/backward/turn-left/turn-right, r = reset,
    v = toggle camera/top view, q = quit (the reference key map).

    Display selection, like the reference's minifb-window-or-nothing but
    with graceful degradation: a real X11 window when ``$DISPLAY`` is set
    and libX11 loads (``window=None`` auto-detects; ``True`` forces,
    ``False`` suppresses), else ANSI half-blocks on a TTY, else a single
    dumped frame.  ``env=None`` plays :func:`default_env` on ``device``.
    """
    from .. import rng

    if env is None:
        env = default_env(device)
    state, obs = env.reset(rng.PRNGKey(seed))

    view = 0  # 0 = camera (the reference's CAMERA_VIEW), 1 = top
    steps = 0

    if window is None:
        window = Window.available()
    if window:
        win = _play_windowed(env, state, seed, out)
        if win:
            return
        out.write("(no X11 window available; falling back to terminal)\n")

    def draw():
        img = env.camera_view(state)[0] if view == 0 else env.top_view(state)[0]
        out.write("\x1b[H\x1b[2J")
        out.write(ansi_frame(img, max_width=max_width))
        out.write(
            f"steps={steps} reward={float(state.reward[0]):.1f} "
            f"done={bool(state.done[0])}  [wasd move/turn, r reset, v view, q quit]\n"
        )
        out.flush()

    if not sys.stdin.isatty():
        draw()
        out.write("(no TTY: rendered one frame and exited)\n")
        return

    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        draw()
        while True:
            ch = sys.stdin.read(1)
            if ch == "q":
                break
            elif ch == "r":
                state, obs = env.reset(rng.PRNGKey(seed + steps + 1))
                steps = 0
            elif ch == "v":
                view = 1 - view
            elif ch in ACTION_KEYS:
                state = env.step(state, _actions(env, ACTION_KEYS.index(ch))).state
                steps += 1
            else:
                continue
            draw()
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def _play_windowed(env, state, seed: int, out) -> bool:
    """X11-window play loop (the reference's minifb loop: per keypress step
    + reblit, vsync'd wait).  Returns False if no window could be opened."""
    import time

    from .. import rng

    cam0 = to_numpy(env.camera_view(state)[0])
    top0 = to_numpy(env.top_view(state)[0])
    # Window sized to the larger view, like the reference.
    h = max(cam0.shape[0], top0.shape[0])
    w = max(cam0.shape[1], top0.shape[1])
    win = Window.open("raycastworlds_tpu_torch (wasd move, r reset, v view, q quit)", h, w)
    if win is None:
        return False

    view = 0
    steps = 0

    def frame():
        img = to_numpy((env.camera_view if view == 0 else env.top_view)(state)[0])
        fh, fw = img.shape
        if (fh, fw) != (h, w):  # center the smaller view on black
            padded = np.zeros((h, w), np.uint32)
            oi, oj = (h - fh) // 2, (w - fw) // 2
            padded[oi : oi + fh, oj : oj + fw] = img
            img = padded
        return img

    try:
        win.update(frame())
        while True:
            ch = win.poll_key()
            if ch is None:
                time.sleep(1.0 / 60.0)  # the reference's mfb_wait_sync
                continue
            if ch in ("q", "close"):
                break
            elif ch == "r":
                state, _ = env.reset(rng.PRNGKey(seed + steps + 1))
                steps = 0
            elif ch == "v":
                view = 1 - view
            elif ch in ACTION_KEYS:
                state = env.step(state, _actions(env, ACTION_KEYS.index(ch))).state
                steps += 1
            else:
                continue
            win.update(frame())
            out.write(
                f"steps={steps} reward={float(state.reward[0]):.1f} "
                f"done={bool(state.done[0])}\n"
            )
            out.flush()
    finally:
        win.close()
    return True
