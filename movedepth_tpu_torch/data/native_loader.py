"""ctypes binding of the port's C++ loader core (``csrc/loader.cpp``): the
counterpart of ``movedepth_tpu/data/native_loader.py``, with the same
functions, signatures and outputs.

The library is built at first use by ``native.build_loader`` in the route
the host supports (``native.loader_route``): route ``"a"`` decodes JPEG and
PNG in C++ (libjpeg, libpng), one OS thread per image; route ``"b"``
decodes with Pillow in the calling thread, into uint8 RGB, and hands the
images to the same C++ flip, chained float Lanczos pyramid and jitter
(``md_pyramid_batch``). The library is loaded with ``ctypes.CDLL``, so its
calls release the GIL, as Pillow's decoder does.

Unlike the JAX package's binding, a library that cannot be built or
loaded is an error, never a quiet switch to PIL: :func:`get` raises
:class:`NativeLoaderUnavailable` with the compiler's output and the
option that reads with PIL instead (``--no-native_loader``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from movedepth_tpu_torch import native

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_INTP = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "md_jitter_batch": ([_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         _F32P, _U8P, ctypes.c_int], None),
    "md_load_batch": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _U8P,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(_F32P), ctypes.c_int], ctypes.c_int),
    "md_probe": ([ctypes.c_char_p, _INTP, _INTP], ctypes.c_int),
    "md_decode": ([ctypes.c_char_p, _F32P, ctypes.c_int, ctypes.c_int],
                  ctypes.c_int),
    "md_pyramid_batch": ([ctypes.POINTER(_U8P), _INTP, _INTP, ctypes.c_int,
                          _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(_F32P), ctypes.c_int],
                         ctypes.c_int),
}
ROUTES = {"a": ("md_load_batch", "md_probe", "md_decode"),
          "b": ("md_pyramid_batch",)}
DESCRIPTION = {"a": "libjpeg and libpng decode in C++",
               "b": "Pillow decode"}
HINT = ("pass --no-native_loader (native_loader=False) to read images with "
        "PIL instead")
_INV255 = np.float32(1.0) / np.float32(255.0)  # C's 1.0f / 255.0f


class NativeLoaderUnavailable(RuntimeError):
    """The C++ loader could not be built or loaded."""


class NativeLoader:
    """The built and typed library of one route."""

    def __init__(self, route: str):
        self.route = route
        try:
            path = native.build_loader(route)
            self.build_s = native.build_reports.get(f"loader-{route}",
                                                    (None,))[0]
            self.lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as e:
            raise NativeLoaderUnavailable(
                f"the C++ loader (route {route}) is unavailable: {e}\n"
                f"{HINT}") from e
        for fn in ("md_jitter_batch",) + ROUTES[route]:
            argtypes, restype = SIGNATURES[fn]
            getattr(self.lib, fn).argtypes = argtypes
            getattr(self.lib, fn).restype = restype

    def describe(self) -> str:
        return (f"native loader, route {self.route} "
                f"({DESCRIPTION[self.route]}; C++ flip, float Lanczos "
                "pyramid and jitter)")

    def load_batch(self, paths: Sequence[str], width: int, height: int,
                   num_scales: int = 1,
                   flips: Optional[Sequence[bool]] = None,
                   num_threads: int = 8) -> List[np.ndarray]:
        """Decode, flip and pyramid a batch of images in native threads.

        Returns [scale_0 (N, H, W, 3) float32, scale_1 (N, H/2, W/2, 3),
        ...]. A file that does not decode comes back as zeros at every
        scale (the dataset duplicates a missing neighbour itself)."""
        n = len(paths)
        c_flips = None
        if flips is not None:
            c_flips = (ctypes.c_uint8 * n)(*[1 if f else 0 for f in flips])
        outs = [np.empty((n, height >> s, width >> s, 3), np.float32)
                for s in range(num_scales)]
        c_outs = (_F32P * num_scales)(*[o.ctypes.data_as(_F32P)
                                        for o in outs])
        if self.route == "a":
            c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
            self.lib.md_load_batch(c_paths, n, c_flips, width, height,
                                   num_scales, c_outs, num_threads)
            return outs
        imgs = [_decode_u8(p) for p in paths]  # held while C reads them
        c_imgs = (_U8P * n)()
        for i, img in enumerate(imgs):
            if img is not None:
                c_imgs[i] = img.ctypes.data_as(_U8P)
        ws = (ctypes.c_int * n)(*[0 if a is None else a.shape[1]
                                  for a in imgs])
        hs = (ctypes.c_int * n)(*[0 if a is None else a.shape[0]
                                  for a in imgs])
        self.lib.md_pyramid_batch(c_imgs, ws, hs, n, c_flips, width, height,
                                  num_scales, c_outs, num_threads)
        return outs

    def jitter_batch(self, imgs: np.ndarray, params: Sequence[float],
                     order: Sequence[int],
                     num_threads: int = 8) -> np.ndarray:
        """The 4-op colour jitter on (N, H, W, 3) float32 images in C++:
        ``params`` = (brightness, contrast, saturation, hue), ``order`` the
        op permutation, as ``data/kitti.py::draw_jitter_params`` draws
        them; the arithmetic of ``_apply_jitter_np``. In place on a
        C-contiguous float32 input; returns the jittered array."""
        imgs = np.ascontiguousarray(imgs, np.float32)
        n, h, w, c = imgs.shape
        if c != 3:
            raise ValueError(f"expected (N, H, W, 3) images, got {imgs.shape}")
        c_params = (ctypes.c_float * 4)(*[float(p) for p in params])
        c_order = (ctypes.c_uint8 * 4)(*[int(o) for o in order])
        self.lib.md_jitter_batch(imgs.ctypes.data_as(_F32P), n, h, w,
                                 c_params, c_order, num_threads)
        return imgs

    def decode(self, path: str) -> Optional[np.ndarray]:
        """One image at its own resolution -> (H, W, 3) float32 in [0, 1],
        or None where it does not decode."""
        if self.route == "b":
            img = _decode_u8(path)
            return None if img is None else img * _INV255
        w, h = ctypes.c_int(), ctypes.c_int()
        if self.lib.md_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)):
            return None
        out = np.empty((h.value, w.value, 3), np.float32)
        if self.lib.md_decode(path.encode(), out.ctypes.data_as(_F32P),
                              w.value, h.value):
            return None
        return out


def _decode_u8(path: str) -> Optional[np.ndarray]:
    """Route b's decode: (H, W, 3) uint8 RGB, or None where the file is
    missing or does not decode (zeros, as route a gives)."""
    try:
        with Image.open(path) as img:
            return np.ascontiguousarray(img.convert("RGB"), np.uint8)
    except OSError:
        return None


_lock = threading.Lock()
_loaders: Dict[Tuple[str, str], NativeLoader] = {}


def get(route: Optional[str] = None) -> NativeLoader:
    """The loader of ``route`` (default: the host's), built and loaded at
    first use with the current compiler; raises
    :class:`NativeLoaderUnavailable` where that fails."""
    key = (route or native.loader_route(), native.cxx())
    with _lock:
        if key not in _loaders:
            _loaders[key] = NativeLoader(key[0])
        return _loaders[key]


def available() -> bool:
    try:
        get()
    except NativeLoaderUnavailable:
        return False
    return True


def jitter_available() -> bool:
    return available()


def load_batch(paths: Sequence[str], width: int, height: int,
               num_scales: int = 1, flips: Optional[Sequence[bool]] = None,
               num_threads: int = 8) -> List[np.ndarray]:
    """:meth:`NativeLoader.load_batch` of the host's route."""
    return get().load_batch(paths, width, height, num_scales, flips,
                            num_threads)


def jitter_batch(imgs: np.ndarray, params: Sequence[float],
                 order: Sequence[int], num_threads: int = 8) -> np.ndarray:
    """:meth:`NativeLoader.jitter_batch` of the host's route."""
    return get().jitter_batch(imgs, params, order, num_threads)


def decode(path: str) -> Optional[np.ndarray]:
    """:meth:`NativeLoader.decode` of the host's route."""
    return get().decode(path)
