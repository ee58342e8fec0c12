"""Zstandard frames through the system libzstd, bound with ctypes.

The checkpoint and reference-blob formats are plain zstd frames
(io/checkpoint.py).  Binding libzstd directly, as native/__init__.py binds
the parser, keeps the package free of a compiled Python extension: the
shared library ships with every Linux distribution.  Streaming in both
directions keeps peak host memory at one chunk, whatever the table size.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

_E_CONTINUE, _E_END = 0, 2     # ZSTD_EndDirective
_C_COMPRESSION_LEVEL = 100     # ZSTD_cParameter


class ZstdError(RuntimeError):
    pass


class _Buffer(ctypes.Structure):
    # ZSTD_inBuffer and ZSTD_outBuffer share this layout
    _fields_ = [
        ("ptr", ctypes.c_void_p),
        ("size", ctypes.c_size_t),
        ("pos", ctypes.c_size_t),
    ]


_lib = None


def _zstd() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        lib = ctypes.CDLL(name)
        p, sz = ctypes.c_void_p, ctypes.c_size_t
        buf = ctypes.POINTER(_Buffer)
        for fn, res, args in (
            ("ZSTD_isError", ctypes.c_uint, [sz]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [sz]),
            ("ZSTD_createCCtx", p, []),
            ("ZSTD_freeCCtx", sz, [p]),
            ("ZSTD_CCtx_setParameter", sz, [p, ctypes.c_int, ctypes.c_int]),
            ("ZSTD_compressStream2", sz, [p, buf, buf, ctypes.c_int]),
            ("ZSTD_CStreamOutSize", sz, []),
            ("ZSTD_createDCtx", p, []),
            ("ZSTD_freeDCtx", sz, [p]),
            ("ZSTD_decompressStream", sz, [p, buf, buf]),
            ("ZSTD_DStreamInSize", sz, []),
        ):
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        _lib = lib
    return _lib


def _check(code: int) -> int:
    lib = _zstd()
    if lib.ZSTD_isError(code):
        raise ZstdError(lib.ZSTD_getErrorName(code).decode())
    return code


def _view(data, writable: bool = False) -> np.ndarray:
    """A uint8 numpy view of a contiguous buffer (for its address)."""
    if isinstance(data, np.ndarray):  # any dtype, bfloat16 included
        if not data.flags.c_contiguous:
            raise ValueError("zstd buffers must be C-contiguous")
        arr = data.reshape(-1).view(np.uint8)
    else:
        arr = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    if writable and not arr.flags.writeable:
        raise ValueError("readinto needs a writable buffer")
    return arr


class Writer:
    """Compresses everything written to it into one frame on file `f`."""

    def __init__(self, f, level: int = 3):
        lib = _zstd()
        self._f = f
        self._cctx = lib.ZSTD_createCCtx()
        _check(lib.ZSTD_CCtx_setParameter(self._cctx, _C_COMPRESSION_LEVEL, level))
        self._out = np.empty(lib.ZSTD_CStreamOutSize(), np.uint8)

    def _pump(self, src: np.ndarray, end: int) -> None:
        lib = _zstd()
        inb = _Buffer(src.ctypes.data, src.size, 0)
        while True:
            outb = _Buffer(self._out.ctypes.data, self._out.size, 0)
            left = _check(lib.ZSTD_compressStream2(
                self._cctx, ctypes.byref(outb), ctypes.byref(inb), end
            ))
            self._f.write(self._out[: outb.pos].tobytes())
            if inb.pos == inb.size and (end == _E_CONTINUE or left == 0):
                return

    def write(self, data) -> None:
        self._pump(_view(data), _E_CONTINUE)

    def close(self) -> None:
        if self._cctx is not None:
            try:
                self._pump(np.empty(0, np.uint8), _E_END)
            finally:
                _zstd().ZSTD_freeCCtx(self._cctx)
                self._cctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Reader:
    """Decompresses the zstd frames of file `f` as a byte stream."""

    def __init__(self, f):
        lib = _zstd()
        self._f = f
        self._dctx = lib.ZSTD_createDCtx()
        self._chunk = lib.ZSTD_DStreamInSize()
        self._src = np.empty(0, np.uint8)
        self._pos = 0
        self._eof = False
        self._pending = 0

    def readinto(self, buf) -> int:
        """Fill `buf` from the stream; fewer bytes only at its end."""
        lib = _zstd()
        dst = _view(buf, writable=True)
        outb = _Buffer(dst.ctypes.data, dst.size, 0)
        while outb.pos < outb.size:
            if self._pos == self._src.size and not self._eof:
                self._src = np.frombuffer(self._f.read(self._chunk), np.uint8)
                self._pos = 0
                self._eof = not self._src.size
            inb = _Buffer(
                self._src.ctypes.data + self._pos, self._src.size - self._pos, 0
            )
            before = outb.pos
            left = _check(lib.ZSTD_decompressStream(
                self._dctx, ctypes.byref(outb), ctypes.byref(inb)
            ))
            self._pos += inb.pos
            if inb.pos or outb.pos != before:
                self._pending = left  # 0: the last frame ended cleanly
            elif self._eof:
                if self._pending:
                    raise ZstdError("truncated zstd frame")
                break  # input spent and nothing left buffered
        return outb.pos

    def read(self, n: int = -1) -> bytes:
        if n >= 0:
            buf = bytearray(n)
            return bytes(buf[: self.readinto(buf)])
        parts = []
        while True:
            part = self.read(1 << 20)
            if not part:
                return b"".join(parts)
            parts.append(part)

    def close(self) -> None:
        if self._dctx is not None:
            _zstd().ZSTD_freeDCtx(self._dctx)
            self._dctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def compress(data, level: int = 3) -> bytes:
    import io

    out = io.BytesIO()
    with Writer(out, level) as w:
        w.write(data)
    return out.getvalue()


def decompress(data) -> bytes:
    import io

    with Reader(io.BytesIO(bytes(data))) as r:
        return r.read()
