"""ctypes surface of the hctpu native runtime, for the port.

The host C++ source ``native/hctpu.cpp`` (the bit-exact v1 encoder and
decoder of the reference format, and the v2 chunked FGK container) is
compiled with g++ on first use into ``build/torch_native/`` under the
repository root; the library name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library never loaded.
This is host code, not a GPU kernel: the v1 FGK chain is serial per
symbol. A failed build or load raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "hctpu.cpp"
BUILD_DIR = _ROOT / "build" / "torch_native"
CXX_FLAGS = ("-std=c++17", "-O3", "-march=native", "-fPIC", "-shared",
             "-pthread")

# reference exit-code table, for error messages
_ERRORS = {
    6: "invalid size of input 2D data detected",
    8: "invalid or missing Huffman coding header",
    9: "invalid Huffman coding file contents",
    10: "invalid or missing adaptive block RLE header",
    11: "invalid adaptive block RLE header",
    12: "too small 2D data dimensions",
    13: "invalid adaptive block RLE file contents",
    14: "unexpected end of adaptive block RLE data",
    15: "leftover data of adaptive block RLE detected",
    40: "invalid v2 container",
    99: "internal error in native runtime",
}


class NativeError(RuntimeError):
    """Raised when the native runtime reports a reference error code."""

    def __init__(self, code: int):
        super().__init__(_ERRORS.get(code, f"native error {code}"))
        self.code = code


_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhctpu-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the runtime unless its library is already there."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the v1/v2 host runtime needs a "
                           "C++17 compiler (set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"native runtime build failed (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        out_t = ctypes.POINTER(u8p)
        n_t = ctypes.POINTER(ctypes.c_uint64)
        lib.hctpu_v1_compress.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, out_t, n_t,
        ]
        lib.hctpu_v1_decompress.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int, out_t, n_t,
        ]
        lib.hctpu_v2_compress.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int, out_t, n_t,
        ]
        lib.hctpu_v2_decompress.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int, out_t, n_t,
        ]
        lib.hctpu_rle_encode.argtypes = [u8p, ctypes.c_uint64, out_t, n_t]
        lib.hctpu_rle_decode.argtypes = [u8p, ctypes.c_uint64, out_t, n_t]
        lib.hctpu_free.argtypes = [u8p]
        for fn in (lib.hctpu_v1_compress, lib.hctpu_v1_decompress,
                   lib.hctpu_v2_compress, lib.hctpu_v2_decompress,
                   lib.hctpu_rle_encode, lib.hctpu_rle_decode):
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """Whether the runtime builds and loads here. A query only: every
    other function of this module raises when it does not."""
    try:
        _load()
        return True
    except (OSError, RuntimeError, AttributeError):  # build, load, symbol
        return False


def _buf(data: bytes):
    return (ctypes.c_uint8 * max(1, len(data))).from_buffer_copy(
        data if data else b"\x00"
    )


def _call(name: str, data: bytes, *args) -> bytes:
    lib = _load()
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_n = ctypes.c_uint64()
    rc = getattr(lib, name)(_buf(data), len(data), *args, ctypes.byref(out),
                            ctypes.byref(out_n))
    if rc != 0:
        raise NativeError(rc)
    try:
        return ctypes.string_at(out, out_n.value)
    finally:
        lib.hctpu_free(out)


def v1_compress(data: bytes, use_diff: bool = False, use_adapt: bool = False,
                width: int = 512, exact: bool = False,
                n_threads: int = 0) -> bytes:
    """Reference-compatible v1 compression (bit-exact with the C++ binary)."""
    threads = n_threads or (os.cpu_count() or 1)
    return _call("hctpu_v1_compress", data, int(use_diff), int(use_adapt),
                 width, int(exact), threads)


def v1_decompress(blob: bytes, exact: bool = False) -> bytes:
    return _call("hctpu_v1_decompress", blob, int(exact))


def v2_compress(data: bytes, use_diff: bool = False, use_adapt: bool = False,
                width: int = 512, chunk_size: int = 1 << 16,
                n_threads: int = 0) -> bytes:
    """The v2 chunked FGK container (host thread-parallel encode)."""
    threads = n_threads or (os.cpu_count() or 1)
    return _call("hctpu_v2_compress", data, int(use_diff), int(use_adapt),
                 width, chunk_size, threads)


def v2_decompress(blob: bytes, n_threads: int = 0) -> bytes:
    threads = n_threads or (os.cpu_count() or 1)
    return _call("hctpu_v2_decompress", blob, threads)


def rle_encode(data: bytes) -> bytes:
    """MNP-5 byte RLE of the whole of ``data`` (the reference's applyRLE)."""
    return _call("hctpu_rle_encode", data)


def rle_decode(data: bytes) -> bytes:
    """The inverse of ``rle_encode`` (the reference's revertRLE)."""
    return _call("hctpu_rle_decode", data)
