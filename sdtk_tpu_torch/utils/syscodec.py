"""In-process system MPEG codec bindings (libmpg123 / libmp3lame).

A copy of ``sdtk_tpu/utils/syscodec.py``.

The reference toolkit outsources ALL audio transcoding to an external
``ffmpeg`` subprocess (reference speaker-process:52 consumes .mp3/.m4a/...
via ffmpeg; sample extraction speechmatics_backend.py:231-281).  This
framework's primary decoders are first-party (WAV/FLAC/MPEG Layer I+II in
utils/{audio,flacio,mpegaudio}.py); this module is the system-codec tier
below them: when the host has ``libmpg123`` / ``libmp3lame`` shared
libraries (no CLI needed — loaded in-process via ctypes), real-world
MPEG Layer III files decode and review samples are written as genuinely
interoperable Layer III ``.mp3``.

Both entry points degrade gracefully: ``mpg123_available()`` /
``lame_available()`` are False when the libraries are absent, and callers
(utils/audio.py) fall back to the first-party codecs — mirroring the
reference's tolerate-missing-tool discipline (speaker-assign:325-326).

Also used by tests as the *oracle* for the first-party MPEG codecs:
lame produces genuine Layer III streams to decode, and mpg123's output is
the ground truth the first-party decoder is scored against.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_MPG123_OK = 0
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12
_ENC_FLOAT_32 = 0x200  # MPG123_ENC_FLOAT_32
_CH_BOTH = 0x3  # MPG123_MONO | MPG123_STEREO

_lock = threading.Lock()
_mpg123_lib: ctypes.CDLL | None | bool = None
_lame_lib: ctypes.CDLL | None | bool = None


class SysCodecError(RuntimeError):
    pass


def _load_mpg123() -> ctypes.CDLL | None:
    global _mpg123_lib
    with _lock:
        if _mpg123_lib is None:
            try:
                lib = ctypes.CDLL("libmpg123.so.0")
                lib.mpg123_new.restype = ctypes.c_void_p
                lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                           ctypes.POINTER(ctypes.c_int)]
                lib.mpg123_delete.argtypes = [ctypes.c_void_p]
                lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
                lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_size_t]
                lib.mpg123_read.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.POINTER(ctypes.c_size_t),
                ]
                lib.mpg123_getformat.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ]
                lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
                lib.mpg123_format.argtypes = [
                    ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                ]
                lib.mpg123_rates.argtypes = [
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_long)),
                    ctypes.POINTER(ctypes.c_size_t),
                ]
                try:
                    lib.mpg123_init()
                except Exception:
                    pass  # no-op/absent in newer libmpg123
                _mpg123_lib = lib
            except OSError:
                _mpg123_lib = False
    return _mpg123_lib or None


def _load_lame() -> ctypes.CDLL | None:
    global _lame_lib
    with _lock:
        if _lame_lib is None:
            try:
                lib = ctypes.CDLL("libmp3lame.so.0")
                lib.lame_init.restype = ctypes.c_void_p
                for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
                           "lame_set_brate", "lame_set_mode",
                           "lame_set_quality", "lame_init_params",
                           "lame_close"):
                    getattr(lib, fn).argtypes = [ctypes.c_void_p] + (
                        [ctypes.c_int] if fn.startswith("lame_set") else []
                    )
                lib.lame_encode_buffer_ieee_float.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                    ctypes.c_char_p, ctypes.c_int,
                ]
                lib.lame_encode_flush.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ]
                _lame_lib = lib
            except OSError:
                _lame_lib = False
    return _lame_lib or None


def mpg123_available() -> bool:
    return _load_mpg123() is not None


def lame_available() -> bool:
    return _load_lame() is not None


def decode_mpeg(data: bytes) -> tuple[np.ndarray, int]:
    """Decode any MPEG audio stream (Layer I/II/III, MPEG-1/2/2.5) via
    libmpg123's feed API → (float32 [T, C], sample_rate)."""
    lib = _load_mpg123()
    if lib is None:
        raise SysCodecError("libmpg123 not available on this host")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise SysCodecError(f"mpg123_new failed (err {err.value})")
    try:
        # Accept ONLY float32 output at any rate/channel count.
        rates = ctypes.POINTER(ctypes.c_long)()
        n_rates = ctypes.c_size_t(0)
        lib.mpg123_rates(ctypes.byref(rates), ctypes.byref(n_rates))
        lib.mpg123_format_none(h)
        for i in range(n_rates.value):
            lib.mpg123_format(h, rates[i], _CH_BOTH, _ENC_FLOAT_32)
        if lib.mpg123_open_feed(h) != _MPG123_OK:
            raise SysCodecError("mpg123_open_feed failed")
        if lib.mpg123_feed(h, data, len(data)) != _MPG123_OK:
            raise SysCodecError("mpg123_feed failed")

        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        chunks: list[bytes] = []
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(buf.raw[: done.value])
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(
                    h, ctypes.byref(rate), ctypes.byref(channels),
                    ctypes.byref(encoding),
                )
                continue
            if rc == _MPG123_OK:
                continue
            if rc in (_MPG123_NEED_MORE, _MPG123_DONE):
                break  # stream exhausted (feed API signals NEED_MORE at EOF)
            raise SysCodecError(f"mpg123_read error {rc}")
        if not chunks or rate.value <= 0 or channels.value <= 0:
            raise SysCodecError("no decodable MPEG audio frames found")
        pcm = np.frombuffer(b"".join(chunks), dtype=np.float32)
        ch = channels.value
        pcm = pcm[: (len(pcm) // ch) * ch].reshape(-1, ch)
        return pcm.copy(), int(rate.value)
    finally:
        lib.mpg123_delete(h)


def encode_mp3(
    x: np.ndarray, sample_rate: int, bitrate_kbps: int = 128
) -> bytes:
    """Encode float32 [-1,1] mono PCM to a genuine MPEG Layer III stream
    via libmp3lame (the interoperable ``.mp3`` the reference got from
    ffmpeg, speaker_samples:280-326)."""
    lib = _load_lame()
    if lib is None:
        raise SysCodecError("libmp3lame not available on this host")
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float32).reshape(-1))
    gfp = lib.lame_init()
    if not gfp:
        raise SysCodecError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, int(sample_rate))
        lib.lame_set_num_channels(gfp, 1)
        lib.lame_set_brate(gfp, int(bitrate_kbps))
        lib.lame_set_mode(gfp, 3)  # MONO
        lib.lame_set_quality(gfp, 2)
        if lib.lame_init_params(gfp) < 0:
            raise SysCodecError(
                f"lame_init_params rejected rate={sample_rate} "
                f"bitrate={bitrate_kbps}"
            )
        out_size = len(x) + len(x) // 4 + 7200
        out = ctypes.create_string_buffer(out_size)
        ptr = x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        n = lib.lame_encode_buffer_ieee_float(gfp, ptr, ptr, len(x), out, out_size)
        if n < 0:
            raise SysCodecError(f"lame_encode_buffer failed ({n})")
        stream = out.raw[:n]
        n = lib.lame_encode_flush(gfp, out, out_size)
        if n < 0:
            raise SysCodecError(f"lame_encode_flush failed ({n})")
        return stream + out.raw[:n]
    finally:
        lib.lame_close(gfp)
