"""The JAX package's C++ library (``native/`` built by ``make`` into
``sdtk_tpu/_native/``), loaded for tests that hold the port's host library
against it.

That package builds its library in place at first use, so under several
pytest workers one process can find the file half written, and its loader
then reports the library unavailable for the rest of the process: JAX's
``load_audio`` would quietly take its Python path.  These helpers wait the
build out, and fail rather than skip when the library never loads.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WAIT_S = 180.0


def ensure_jax_native():
    """JAX's library loaded in this process (its loader's "unavailable"
    forgotten and retried until ``WAIT_S``); raises AssertionError if it
    never loads."""
    from sdtk_tpu.utils import hashing, nativelib

    deadline = time.monotonic() + WAIT_S
    while True:
        lib = nativelib.get_lib()
        if lib is not None and hashing._find_native() is not None:
            return lib
        if time.monotonic() > deadline:
            raise AssertionError("the JAX package's native library did not load")
        nativelib._lib = None
        hashing._native_lib = None
        time.sleep(1.0)


def run_jax(code: str, payload: dict, env: dict | None = None) -> dict:
    """Run ``code`` in a fresh interpreter with the JAX package importable
    and ``payload`` as JSON on its argv; it prints one JSON object last,
    with ``"native": false`` when JAX's loader found no library.  A run
    that saw no library, or died, is retried (a build in another process
    may be under way) until ``WAIT_S``; then AssertionError."""
    deadline = time.monotonic() + WAIT_S
    full_env = {**os.environ, "PYTHONPATH": str(REPO), **(env or {})}
    last = ""
    while time.monotonic() < deadline:
        proc = subprocess.run([sys.executable, "-c", code, json.dumps(payload)], cwd=REPO,
                              env=full_env, capture_output=True, text=True, timeout=600)
        if proc.returncode == 0:
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            if out.get("native"):
                return out
            last = "the native library was unavailable"
        else:
            last = proc.stderr[-2000:]
        time.sleep(1.0)
    raise AssertionError(f"JAX's side never ran with its native library: {last}")
