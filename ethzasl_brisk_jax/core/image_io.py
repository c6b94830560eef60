"""Grayscale image IO (PGM/PPM) for the golden-data toolchain.

The reference test corpus is 8-bit binary PGM (``test_data/img{1,2}.pgm``);
the reference's own minimal loader is ``brisk/src/brisk-opencv.cc:67+``.
This is a clean NumPy re-implementation of the (public) netpbm format.
"""
from __future__ import annotations

import numpy as np

try:  # Native IO runtime (native/briskio.cc; build with native/build.py).
    from ethzasl_brisk_jax._native import briskio as _briskio
except ImportError:  # pure-Python fallback
    _briskio = None


def read_pgm(path: str) -> np.ndarray:
    """Read an 8/16-bit PGM; uses the native loader when built (8-bit)."""
    if _briskio is not None:
        try:
            h, w, data = _briskio.read_pgm(path)
            return np.frombuffer(data, np.uint8).reshape(h, w).copy()
        except IOError:
            pass  # e.g. 16-bit — fall through to the Python reader
    return _read_pgm_py(path)


def read_pgm_batch(paths, n_threads: int = 8) -> np.ndarray:
    """Read a batch of same-sized 8-bit PGMs -> (N, H, W) uint8.

    Uses the multithreaded native loader when available — the host side
    of the frame pipeline's data-loading stage.
    """
    if _briskio is not None:
        entries = _briskio.read_batch(list(paths), n_threads)
        return np.stack(
            [
                np.frombuffer(d, np.uint8).reshape(h, w)
                for h, w, d in entries
            ]
        )
    return np.stack([read_pgm(p) for p in paths])


def _read_pgm_py(path: str) -> np.ndarray:
    """Pure-Python PGM reader (P2 ascii or P5 binary, 8/16-bit)."""
    with open(path, "rb") as f:
        data = f.read()

    # Tokenize header: magic, width, height, maxval — comments start with '#'.
    pos = 0

    def next_token():
        nonlocal pos
        while pos < len(data):
            c = data[pos : pos + 1]
            if c == b"#":
                while pos < len(data) and data[pos : pos + 1] != b"\n":
                    pos += 1
            elif c.isspace():
                pos += 1
            else:
                break
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        return data[start:pos]

    magic = next_token()
    if magic not in (b"P2", b"P5"):
        raise ValueError(f"not a PGM file: magic={magic!r}")
    width = int(next_token())
    height = int(next_token())
    maxval = int(next_token())
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")

    if magic == b"P5":
        pos += 1  # single whitespace after maxval
        itemsize = np.dtype(dtype).itemsize
        raster = np.frombuffer(
            data, dtype=dtype, count=width * height, offset=pos
        )
    else:
        vals = data[pos:].split()
        raster = np.array([int(v) for v in vals[: width * height]], dtype=dtype)
    img = raster.reshape(height, width)
    if maxval >= 256:
        img = img.astype(np.uint16)
    return np.ascontiguousarray(img)


def write_pgm(path: str, img: np.ndarray) -> None:
    """Write a 2-D uint8/uint16 array as binary PGM (P5)."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("write_pgm expects a 2-D array")
    if img.dtype == np.uint8:
        maxval = 255
        payload = img.tobytes()
    elif img.dtype == np.uint16:
        maxval = 65535
        payload = img.astype(">u2").tobytes()
    else:
        raise ValueError(f"unsupported dtype {img.dtype}")
    header = f"P5\n{img.shape[1]} {img.shape[0]}\n{maxval}\n".encode()
    with open(path, "wb") as f:
        f.write(header + payload)
