"""ctypes bindings to the native host-runtime library (native/ggrt_native.cpp;
the JAX package's native.py): the anti-aliased resize, camera-distance
scoring and a single-producer single-consumer blob ring for loader
prefetch.

At first use g++ compiles the source, unchanged, into the git-ignored
`ggrt_official_torch/_build/native/`, named by the hash of the source. Each
entry keeps a fallback for a machine with no compiler: the resize falls
back to the port's numpy blur and bilinear resize (`data/llff.py`, the
reference's cv2 pair), the distances to numpy, the ring to a deque.
`available()` says which path runs.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "ggrt_native.cpp"
_BUILD = Path(__file__).resolve().parent / "_build" / "native"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False
build_log = ""


def _build() -> Path | None:
    """Compile the library once per source hash; its path, or None if g++
    is missing or fails (the compiler's output is kept in `build_log`)."""
    global build_log
    so = _BUILD / f"libggrt_native_{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_log = str(e)
        return None
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        return None
    os.replace(tmp, so)
    return so


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build() if _SRC.exists() else None
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.resize_bilinear_aa.argtypes = [f32p] + [ctypes.c_int] * 3 + [f32p] + [ctypes.c_int] * 2
    lib.resize_bilinear_aa.restype = None
    lib.pose_distances.argtypes = [f32p, ctypes.c_int, f32p, f32p]
    lib.pose_distances.restype = None
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_int]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_destroy.restype = None
    lib.ring_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64]
    lib.ring_push.restype = ctypes.c_int
    lib.ring_pop.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64]
    lib.ring_pop.restype = ctypes.c_int64
    lib.ring_size.argtypes = [ctypes.c_void_p]
    lib.ring_size.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library runs (built and loaded); False means every
    entry takes its fallback."""
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_bilinear_aa(image: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Anti-aliased float32 HWC resize (box prefilter when shrinking, then
    bilinear). Without the library: the loader's blur and bilinear resize."""
    image = np.ascontiguousarray(image, np.float32)
    if image.ndim != 3:
        raise ValueError(f"resize_bilinear_aa takes an (h, w, c) image, not {image.shape}")
    h, w, c = image.shape
    dh, dw = out_hw
    lib = get_lib()
    if lib is not None:
        out = np.empty((dh, dw, c), np.float32)
        lib.resize_bilinear_aa(_fptr(image), h, w, c, _fptr(out), dh, dw)
        return out
    from .data.image_io import resize
    from .data.llff import downsample_gaussian_blur

    return resize(downsample_gaussian_blur(image, dh / h), out_hw, "linear")


def pose_distances(ref_c2w: np.ndarray, tar_c2w: np.ndarray) -> np.ndarray:
    """Camera-centre distances (n,) from (n, 4, 4) references to one (4, 4) target."""
    ref = np.ascontiguousarray(ref_c2w, np.float32).reshape(-1, 4, 4)
    tar = np.ascontiguousarray(tar_c2w, np.float32).reshape(4, 4)
    lib = get_lib()
    if lib is not None:
        out = np.empty(ref.shape[0], np.float32)
        lib.pose_distances(_fptr(ref), ref.shape[0], _fptr(tar), _fptr(out))
        return out
    return np.linalg.norm(ref[:, :3, 3] - tar[:3, 3], axis=-1)


class PrefetchRing:
    """Single-producer single-consumer blob ring (native) for producer-thread
    loader prefetch: push returns False when full, pop None when empty."""

    def __init__(self, capacity: int = 8):
        self._lib = get_lib()
        if self._lib is not None:
            self._h = self._lib.ring_create(capacity)
        else:
            self._q = collections.deque(maxlen=capacity)

    def push(self, blob: bytes) -> bool:
        if self._lib is not None:
            arr = np.frombuffer(blob, np.uint8)
            return bool(self._lib.ring_push(self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                            arr.size))
        if len(self._q) == self._q.maxlen:
            return False
        self._q.append(blob)
        return True

    def pop(self, max_size: int = 1 << 26):
        """The oldest blob, or None; a blob longer than `max_size` comes back
        cut to it."""
        if self._lib is not None:
            out = np.empty(max_size, np.uint8)
            n = self._lib.ring_pop(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_size)
            if n < 0:
                return None
            return out[:n].tobytes()
        return self._q.popleft() if self._q else None

    def __len__(self):
        if self._lib is not None:
            return int(self._lib.ring_size(self._h))
        return len(self._q)

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.ring_destroy(self._h)
