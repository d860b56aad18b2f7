"""ctypes binding to the port's crypto library (counterpart: the crypto
part of janus_tpu/net/binding.py): SHA-256 block digests (Block.cs:45-73)
and ECDSA P-256 sign/verify (Replica.cs:34-42, Block.cs:75-88).

The library is the port's own copy of the JAX package's ``sha256.cc`` and
``ecdsa.cc`` (``janus_tpu_torch/native/``), built with ``g++ -O2 -fPIC
-shared -ldl`` into ``janus_tpu_torch/build/libjanus_crypto.so`` at first
use, and again whenever a source is newer than it. ``ecdsa.cc`` dlopens
the system's ``libcrypto.so.3``; without it ``ecdsa_available()`` is
False and the split node signs with a keyed SHA-256 hash instead.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
NATIVE = _PKG / "native"
SOURCES = ("sha256.cc", "ecdsa.cc")
LIB_PATH = _PKG / "build" / "libjanus_crypto.so"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    deps = [NATIVE / f for f in SOURCES] + [NATIVE / "janus_native.h"]
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= max(
            p.stat().st_mtime for p in deps):
        return
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
           *(str(NATIVE / f) for f in SOURCES), "-ldl"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("building the crypto library failed:\n"
                           + res.stdout + res.stderr)
    os.replace(tmp, LIB_PATH)


def load() -> ctypes.CDLL:
    """Build (if stale) and load the crypto library; idempotent."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _build()
        lib = ctypes.CDLL(str(LIB_PATH))
        c = ctypes
        u8p, i32p = c.POINTER(c.c_uint8), c.POINTER(c.c_int32)
        lib.janus_sha256.argtypes = [u8p, c.c_size_t, u8p]
        lib.janus_sha256.restype = None
        lib.janus_ecdsa_available.argtypes = []
        lib.janus_ecdsa_available.restype = c.c_int
        for f in ("keygen", "sign", "verify"):
            getattr(lib, f"janus_ecdsa_{f}").restype = c.c_int
        lib.janus_ecdsa_keygen.argtypes = [u8p, i32p, u8p, i32p]
        lib.janus_ecdsa_sign.argtypes = [u8p, c.c_int, u8p, c.c_size_t, u8p,
                                         i32p]
        lib.janus_ecdsa_verify.argtypes = [u8p, c.c_int, u8p, c.c_size_t,
                                           u8p, c.c_int]
        _lib = lib
        return lib


def sha256(data: bytes) -> bytes:
    lib = load()
    out = (ctypes.c_uint8 * 32)()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else None
    lib.janus_sha256(buf, len(data), out)
    return bytes(out)


def ecdsa_available() -> bool:
    return bool(load().janus_ecdsa_available())


def ecdsa_keygen() -> Tuple[bytes, bytes]:
    """(priv_der, pub_der); raises if libcrypto is unavailable."""
    lib = load()
    priv = (ctypes.c_uint8 * 512)()
    pub = (ctypes.c_uint8 * 512)()
    pl, ql = ctypes.c_int(512), ctypes.c_int(512)
    rc = lib.janus_ecdsa_keygen(priv, ctypes.byref(pl), pub, ctypes.byref(ql))
    if rc != 0:
        raise RuntimeError(f"ecdsa_keygen failed ({rc})")
    return bytes(priv[: pl.value]), bytes(pub[: ql.value])


def ecdsa_sign(priv_der: bytes, msg: bytes) -> bytes:
    lib = load()
    sig = (ctypes.c_uint8 * 256)()
    sl = ctypes.c_int(256)
    p = (ctypes.c_uint8 * len(priv_der)).from_buffer_copy(priv_der)
    m = (ctypes.c_uint8 * len(msg)).from_buffer_copy(msg) if msg else None
    rc = lib.janus_ecdsa_sign(p, len(priv_der), m, len(msg), sig,
                              ctypes.byref(sl))
    if rc != 0:
        raise RuntimeError(f"ecdsa_sign failed ({rc})")
    return bytes(sig[: sl.value])


def ecdsa_verify(pub_der: bytes, msg: bytes, sig: bytes) -> bool:
    lib = load()
    p = (ctypes.c_uint8 * len(pub_der)).from_buffer_copy(pub_der)
    m = (ctypes.c_uint8 * len(msg)).from_buffer_copy(msg) if msg else None
    s = (ctypes.c_uint8 * len(sig)).from_buffer_copy(sig)
    return lib.janus_ecdsa_verify(p, len(pub_der), m, len(msg), s,
                                  len(sig)) == 0
