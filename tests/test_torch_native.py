"""The port's host library (sdtk_tpu_torch/csrc/host/*.cc, built by
utils/build.py:build_host, bound by utils/nativelib.py) against the JAX
package's (native/*.cc, built by make):

1. ``load_audio`` equals JAX's bit for bit on 8-, 16-, 24- and 32-bit PCM
   and 32-bit float, mono and stereo, at 8, 16, 22.05, 44.1 and 48 kHz,
   read at 16 kHz, at 8 kHz and at the file's rate; each through the C++
   reader on both sides (JAX's ``_load_audio_native`` returned samples).
2. ``load_audio_batch`` equals JAX's, a FLAC among the WAVs.
3. A corrupt WAV raises ``AudioFormatError`` in both packages.
4. ``blake3_native`` equals JAX's at 0, 4 095, 4 096 and 1 MiB + 7 bytes,
   and the published vectors of "" and "abc".
5. ``SDTK_NO_NATIVE_BUILD=1`` as in JAX: a built library is loaded,
   none is built, and without one the Python path runs.
6. The build: several processes at once leave one whole library; a
   missing or failing compiler raises ``KernelError``.

JAX's side runs in a fresh interpreter, retried while its library is
being built by another process (``tests/torch_jax_native.py``).
"""

from __future__ import annotations

import json
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from sdtk_tpu.utils import audio as jaudio
from sdtk_tpu.utils import nativelib as jnativelib
from sdtk_tpu_torch.utils import audio, build, flacio, hashing, nativelib
from torch_jax_native import REPO, ensure_jax_native, run_jax

KINDS = ("pcm8", "pcm16", "pcm24", "pcm32", "float32")
RATES = (8000, 16000, 22050, 44100, 48000)
TARGETS = (16000, 8000, 0)
CASES = [(k, c, r) for k in KINDS for c in (1, 2) for r in RATES]
HASH_SIZES = (0, 4095, 4096, (1 << 20) + 7)


def write_wav(path: Path, x: np.ndarray, sr: int, kind: str) -> None:
    """(frames, channels) float in [-1, 1] → a RIFF/WAVE file of ``kind``,
    with an odd-sized chunk before ``data`` (its pad byte must be skipped)."""
    ch = x.shape[1]
    x = np.asarray(x, np.float64)
    if kind == "pcm8":
        payload, bits, fmt = np.clip(np.round(x * 127) + 128, 0, 255).astype(np.uint8).tobytes(), \
            8, 1
    elif kind == "pcm16":
        payload, bits, fmt = (x * 32767).astype("<i2").tobytes(), 16, 1
    elif kind == "pcm24":
        v = (x * 8388607).astype("<i4").reshape(-1, 1).view(np.uint8).reshape(-1, 4)
        payload, bits, fmt = v[:, :3].tobytes(), 24, 1
    elif kind == "pcm32":
        payload, bits, fmt = (x * 2147483647).astype("<i4").tobytes(), 32, 1
    else:
        payload, bits, fmt = x.astype("<f4").tobytes(), 32, 3
    block = ch * bits // 8
    body = (b"WAVE" + b"fmt " + struct.pack("<IHHIIHH", 16, fmt, ch, sr, sr * block, block, bits)
            + b"junk" + struct.pack("<I", 3) + b"abc\0"
            + b"data" + struct.pack("<I", len(payload)) + payload)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def _signal(n: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 0.4 * np.sin(2 * np.pi * 0.013 * t) + 0.25 * rng.uniform(-1, 1, n)
    cols = [x, 0.6 * np.roll(x, 17) - 0.3 * rng.uniform(-1, 1, n)][:channels]
    return np.stack(cols, axis=1)


# JAX's side: load_audio, _load_audio_native, load_audio_batch and
# blake3_native over the fixture's files; arrays to an .npz
_JAX_CODE = r"""
import json, sys
import numpy as np
from sdtk_tpu.utils import audio, hashing
from sdtk_tpu.utils.nativelib import get_lib
job = json.loads(sys.argv[1])
if get_lib() is None or hashing.blake3_native(b"") is None:
    print(json.dumps({"native": False})); sys.exit(0)
arrays, srs, native = {}, {}, True
for i, (path, target) in enumerate(job["loads"]):
    x, sr = audio.load_audio(path, target_sr=target)
    nat = audio._load_audio_native(__import__("pathlib").Path(path), target)
    native &= nat is not None and nat[1] == sr and np.array_equal(nat[0], x)
    arrays[f"load{i}"], srs[i] = x, sr
for i, x in enumerate(audio.load_audio_batch(job["batch"])):
    arrays[f"batch{i}"] = x
np.savez(job["out"], **arrays)
digests = [hashing.blake3_native(open(p, "rb").read()).hex() for p in job["hashes"]]
print(json.dumps({"native": bool(native), "srs": srs, "digests": digests}))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Every case written once; JAX's outputs over all of them from one
    fresh interpreter with its native library."""
    d = tmp_path_factory.mktemp("native")
    paths = {}
    for i, (kind, ch, sr) in enumerate(CASES):
        paths[kind, ch, sr] = d / f"{kind}_{ch}ch_{sr}.wav"
        write_wav(paths[kind, ch, sr], _signal(int(0.6 * sr) + 7 * i, ch, seed=i), sr, kind)
    flac = d / "clip.flac"
    flac.write_bytes(flacio.encode(_signal(22050, 2, seed=99).astype(np.float32), 44100, 16))
    loads = [(str(p), t) for p in paths.values() for t in TARGETS]
    batch = [str(p) for p in paths.values()] + [str(flac)]
    hashes = []
    for n in HASH_SIZES:
        h = d / f"bytes{n}.bin"
        h.write_bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes())
        hashes.append(str(h))
    out = run_jax(_JAX_CODE, {"loads": loads, "batch": batch, "hashes": hashes,
                              "out": str(d / "jax.npz")})
    arrays = dict(np.load(d / "jax.npz"))
    loaded = {key: (arrays[f"load{i}"], out["srs"][str(i)]) for i, key in enumerate(loads)}
    return {"paths": paths, "loaded": loaded, "batch": batch,
            "batch_out": [arrays[f"batch{i}"] for i in range(len(batch))],
            "digests": dict(zip(HASH_SIZES, out["digests"])), "hash_files": hashes}


@pytest.mark.parametrize("kind,channels,sr", CASES)
def test_load_audio_equals_jax_bit_for_bit(kind, channels, sr, jax_side):
    """At 16 kHz, 8 kHz and the file's rate: the port's samples and rate
    are JAX's, exactly, through the C++ reader on both sides."""
    path = jax_side["paths"][kind, channels, sr]
    for target in TARGETS:
        want, want_sr = jax_side["loaded"][str(path), target]
        got, got_sr = audio.load_audio(path, target_sr=target)
        assert got_sr == want_sr == (target or sr)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        native = audio._load_audio_native(path, target)
        assert native is not None
        np.testing.assert_array_equal(native[0], got)


@pytest.mark.parametrize("n_threads", [0, 3])
def test_load_audio_batch_equals_jax(n_threads, jax_side):
    """The C++ thread pool over every WAV, and the FLAC through
    ``load_audio``: JAX's list, in order, exactly."""
    got = audio.load_audio_batch(jax_side["batch"], n_threads=n_threads)
    assert len(got) == len(jax_side["batch_out"])
    for g, w in zip(got, jax_side["batch_out"]):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[-1], audio.load_audio(jax_side["batch"][-1])[0])


def _corrupt_files(d: Path) -> list[Path]:
    good = d / "good.wav"
    write_wav(good, _signal(1600, 1, 0), 16000, "pcm16")
    data = good.read_bytes()
    files = {
        "short.wav": data[:40],
        "notriff.wav": b"RIFXxxxxWAVE" + data[12:],
        "bits12.wav": data[:34] + struct.pack("<H", 12) + data[36:],
        "nodata.wav": data[:48] + b"xxxx" + data[52:],
        "zerochannels.wav": data[:22] + struct.pack("<H", 0) + data[24:],
    }
    for name, blob in files.items():
        (d / name).write_bytes(blob)
    return [d / name for name in files]


def test_corrupt_wav_raises_in_both(tmp_path):
    """Each corrupt WAV raises the package's ``AudioFormatError`` in both,
    the JAX package on its default (native) path."""
    ensure_jax_native()
    for path in _corrupt_files(tmp_path):
        with pytest.raises(audio.AudioFormatError):
            audio.load_audio(path)
        with pytest.raises(jaudio.AudioFormatError):
            jaudio.load_audio(path)
        with pytest.raises(audio.AudioFormatError):
            audio.load_audio_batch([path])


@pytest.mark.parametrize("n", HASH_SIZES)
def test_blake3_native_equals_jax(n, jax_side):
    data = Path(jax_side["hash_files"][HASH_SIZES.index(n)]).read_bytes()
    got = hashing.blake3_native(data)
    assert got is not None and got.hex() == jax_side["digests"][n]
    assert hashing.blake3(data) == got == hashing.blake3_numpy(data)


def test_blake3_published_vectors():
    """The BLAKE3 reference vectors of "" and "abc", natively and by the
    dispatch."""
    for data, digest in ((b"", "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262"),
                         (b"abc",
                          "6437b3ac38465133ffb63b75273a8db548c558465d79db03fd359c6cd5bd9d85")):
        assert hashing.blake3_native(data).hex() == digest
        assert hashing.blake3(data).hex() == digest


def test_blake3_dispatch_takes_native_from_4096(monkeypatch):
    """Native from 4 096 bytes, scalar below, NumPy where the library is
    absent, as JAX's ``blake3`` dispatches."""
    calls = []
    real = hashing.blake3_native
    monkeypatch.setattr(hashing, "blake3_native", lambda d: calls.append(len(d)) or real(d))
    for n in (0, 4095, 4096, 9000):
        hashing.blake3(bytes(n))
    assert calls == [4096, 9000]
    monkeypatch.setattr(hashing, "blake3_native", lambda d: None)
    monkeypatch.setattr(hashing, "blake3_numpy", lambda d: b"numpy")
    assert hashing.blake3(bytes(4096)) == b"numpy"


@pytest.fixture()
def empty_build_dir(tmp_path, monkeypatch):
    """``_build`` moved to an empty directory, no library bound."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nativelib, "_lib", None)
    return tmp_path / "_build"


def test_no_native_build_without_a_library_takes_the_python_path(empty_build_dir, monkeypatch,
                                                                 jax_side):
    """``SDTK_NO_NATIVE_BUILD=1`` and nothing built: no build, no library,
    and ``load_audio`` takes the Python path, as JAX's does without its
    library (JAX's loader set to "unavailable"); BLAKE3 digests unchanged."""
    monkeypatch.setenv("SDTK_NO_NATIVE_BUILD", "1")
    monkeypatch.setattr(jnativelib, "_lib", False)
    assert nativelib.get_lib() is None and hashing.blake3_native(b"abc") is None
    assert not empty_build_dir.exists()
    path = jax_side["paths"]["pcm16", 2, 44100]
    got, sr = audio.load_audio(path)
    want, want_sr = jaudio.load_audio(path)
    assert sr == want_sr == 16000
    np.testing.assert_array_equal(got, want)
    x, file_sr = audio._decode_wav(path)
    np.testing.assert_array_equal(got, audio.resample(x.mean(axis=1), file_sr, 16000))
    assert audio.load_audio_batch([path])[0].tobytes() == got.tobytes()
    data = Path(jax_side["hash_files"][-1]).read_bytes()
    assert hashing.blake3(data).hex() == jax_side["digests"][HASH_SIZES[-1]]
    assert not empty_build_dir.exists()


def test_no_native_build_loads_a_built_library(empty_build_dir, monkeypatch, jax_side):
    """``SDTK_NO_NATIVE_BUILD=1`` with the library built: it is loaded, in
    the port as in the JAX package (checked in a fresh interpreter)."""
    build.build_host()
    monkeypatch.setenv("SDTK_NO_NATIVE_BUILD", "1")
    assert nativelib.get_lib() is not None
    path = jax_side["paths"]["pcm24", 1, 48000]
    want, _ = jax_side["loaded"][str(path), 16000]
    np.testing.assert_array_equal(audio.load_audio(path)[0], want)
    out = run_jax("import json; from sdtk_tpu.utils.nativelib import get_lib; "
                  "print(json.dumps({'native': get_lib() is not None}))", {},
                  env={"SDTK_NO_NATIVE_BUILD": "1"})
    assert out["native"]


_BUILD_CODE = r"""
import json, sys
from pathlib import Path
from sdtk_tpu_torch.utils import build, hashing, nativelib
build.BUILD_DIR = Path(json.loads(sys.argv[1]))
print(json.dumps({"path": str(nativelib.get_lib()._name),
                  "digest": hashing.blake3_native(b"abc").hex()}))
"""


def test_host_build_across_processes_and_threads(empty_build_dir):
    """Four processes build into one empty directory at once, and four
    threads of this one: every one loads a whole library, the same file,
    and no temporary file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CODE, json.dumps(str(empty_build_dir))],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(build.build_host())) for _ in range(4)]
    for t in threads:
        t.start()
    outs = [p.communicate(timeout=300) for p in procs]
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    results = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert {r["path"] for r in results} == {str(build.host_library_path())} == set(map(str, paths))
    assert {r["digest"] for r in results} == {hashing.blake3_scalar(b"abc").hex()}
    assert sorted(p.name for p in empty_build_dir.iterdir()) == [build.host_library_path().name]


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_missing_or_failing_compiler_raises(cxx, empty_build_dir, monkeypatch):
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.delenv("SDTK_NO_NATIVE_BUILD", raising=False)
    with pytest.raises(build.KernelError):
        nativelib.get_lib()
    assert not build.host_library_path().exists()
    assert not [p for p in empty_build_dir.glob("*.tmp")]


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    """An edited source gets another library name."""
    before = build.host_library_path()
    src = tmp_path / "host"
    src.mkdir()
    for f in build.HOST_SRC.glob("*.cc"):
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "HOST_SRC", src)
    assert build.host_library_path() == before
    (src / "blake3.cc").write_text((src / "blake3.cc").read_text() + "\n// edited\n")
    assert build.host_library_path() != before
