"""Episode recording and GIF export.

The port of the JAX package's ``utils/video.py``, with its own copy of the
writer.  GPU hosts are often headless, so the artifact is a file: record
frames during a rollout (rendered on the env's device, one host copy per
frame) and write an animated GIF.

Writer: Pillow when importable, else a dependency-free GIF89a/LZW encoder
(raycast frames use a handful of palette colors, so 256-entry GIF palettes
are lossless for untextured scenes; textured frames quantize to RGB 3-3-2).
"""

from __future__ import annotations

import struct
from typing import Callable, Optional

import numpy as np

from . import to_numpy


def _to_rgb(frames) -> np.ndarray:
    """[T, H, W] u32 or [T, H, W, 3] u8 (numpy or a tensor) -> [T, H, W, 3] u8."""
    a = to_numpy(frames)
    if a.ndim == 4 and a.shape[-1] == 3:
        return a.astype(np.uint8)
    if a.ndim == 3:
        a = a.astype(np.uint32)
        return np.stack(
            [(a >> 16) & 0xFF, (a >> 8) & 0xFF, a & 0xFF], axis=-1
        ).astype(np.uint8)
    raise ValueError(f"expected [T,H,W] u32 or [T,H,W,3] u8, got {a.shape}")


def save_gif(path: str, frames, fps: float = 15.0, scale: int = 1) -> str:
    """Write frames as an animated GIF.  Returns ``path``.

    frames: [T, H, W] uint32 0x00RRGGBB or [T, H, W, 3] uint8.
    scale:  integer nearest-neighbor upscale (terminal-sized frames are tiny).
    """
    rgb = _to_rgb(frames)
    if scale > 1:
        rgb = rgb.repeat(scale, axis=1).repeat(scale, axis=2)
    duration_ms = max(int(round(1000.0 / fps)), 20)
    try:
        from PIL import Image

        imgs = [Image.fromarray(f) for f in rgb]
        imgs[0].save(
            path,
            save_all=True,
            append_images=imgs[1:],
            duration=duration_ms,
            loop=0,
            optimize=False,
        )
        return path
    except ImportError:
        _write_gif_fallback(path, rgb, duration_ms)
        return path


# ---------------------------------------------------------------------------
# Dependency-free GIF89a writer (global palette + LZW)
# ---------------------------------------------------------------------------


def _palette_and_indices(rgb: np.ndarray):
    t, h, w, _ = rgb.shape
    flat = rgb.reshape(-1, 3)
    colors, inv = np.unique(flat, axis=0, return_inverse=True)
    if len(colors) <= 256:
        return colors, inv.reshape(t, h, w).astype(np.int32)
    # quantize RGB 3-3-2
    q = (
        (flat[:, 0] >> 5).astype(np.int32) << 5
    ) | ((flat[:, 1] >> 5).astype(np.int32) << 2) | (
        flat[:, 2] >> 6
    ).astype(np.int32)
    pal = np.zeros((256, 3), np.uint8)
    idx = np.arange(256)
    pal[:, 0] = ((idx >> 5) & 7) * 255 // 7
    pal[:, 1] = ((idx >> 2) & 7) * 255 // 7
    pal[:, 2] = (idx & 3) * 255 // 3
    return pal, q.reshape(t, h, w)


def _lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    """Standard GIF LZW over a 1-D index stream."""
    clear = 1 << min_code_size
    eoi = clear + 1
    out = bytearray()
    cur = 0
    nbits = 0

    def emit(code: int, size: int):
        nonlocal cur, nbits
        cur |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(cur & 0xFF)
            cur >>= 8
            nbits -= 8

    table = {(i,): i for i in range(clear)}
    next_code = eoi + 1
    code_size = min_code_size + 1
    emit(clear, code_size)
    seq = ()
    for sym in indices.tolist():
        cand = seq + (sym,)
        if cand in table:
            seq = cand
            continue
        emit(table[seq], code_size)
        table[cand] = next_code
        next_code += 1
        if next_code > (1 << code_size) and code_size < 12:
            code_size += 1
        elif next_code >= 4096:
            emit(clear, code_size)
            table = {(i,): i for i in range(clear)}
            next_code = eoi + 1
            code_size = min_code_size + 1
        seq = (sym,)
    if seq:
        emit(table[seq], code_size)
    emit(eoi, code_size)
    if nbits:
        out.append(cur & 0xFF)
    return bytes(out)


def _write_gif_fallback(path: str, rgb: np.ndarray, duration_ms: int) -> None:
    pal, idx = _palette_and_indices(rgb)
    t, h, w = idx.shape
    ncolors = len(pal)
    depth = max((ncolors - 1).bit_length(), 1)
    table_size = 1 << depth
    gct = np.zeros((table_size, 3), np.uint8)
    gct[:ncolors] = pal
    min_code = max(depth, 2)

    with open(path, "wb") as f:
        f.write(b"GIF89a")
        f.write(struct.pack("<HHBBB", w, h, 0xF0 | (depth - 1), 0, 0))
        f.write(gct.tobytes())
        # loop forever
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        delay_cs = max(duration_ms // 10, 2)
        for k in range(t):
            f.write(b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00")
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            f.write(bytes([min_code]))
            data = _lzw_encode(idx[k].reshape(-1), min_code)
            for i in range(0, len(data), 255):
                blk = data[i:i + 255]
                f.write(bytes([len(blk)]) + blk)
            f.write(b"\x00")
        f.write(b"\x3b")


# ---------------------------------------------------------------------------
# Episode recording
# ---------------------------------------------------------------------------


def record_episode(
    env,
    key,
    steps: int = 128,
    policy: Optional[Callable] = None,
    view: str = "camera",
    env_index: int = 0,
) -> np.ndarray:
    """Roll ``steps`` env steps and return uint32 frames [steps+1, H, W]
    ([steps+1, P, H, W] for MultiPlayerRoom's cameras).

    ``policy(key, obs) -> actions`` (defaults to uniform random); ``key`` a
    ``rng.PRNGKey``, split once per step; ``view`` is "camera" or "top" (the
    u32 debug views whatever ``cfg.obs_type``).  Rendering runs on the env's
    device; one frame is copied to the host per step.
    """
    from .. import rng

    render = env.camera_view if view == "camera" else env.top_view
    state, obs = env.reset(key)
    frames = [to_numpy(render(state)[env_index])]
    for _ in range(steps):
        key, k = rng.split(key).unbind(0)
        actions = policy(k, obs) if policy is not None else env.sample_action(k)
        res = env.step(state, actions)
        state, obs = res.state, res.obs
        frames.append(to_numpy(render(state)[env_index]))
    return np.stack(frames).astype(np.uint32)
