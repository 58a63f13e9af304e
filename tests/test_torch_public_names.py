"""The last public functions of ported modules against the JAX package's
(store/migrations.py, utils/hashing.py, data/synth.py, ops/cosine.py,
ops/fbank.py, cli/common.py), and the check that every public ``def`` and
``class`` of ``sdtk_tpu`` has a namesake in ``sdtk_tpu_torch`` but
JAX-only plumbing.  Tolerances are stated in each test."""

from __future__ import annotations

import argparse
import ast
import runpy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtk_tpu.cli import common as jax_common
from sdtk_tpu.data import synth as jax_synth
from sdtk_tpu.ops import cosine as jax_cosine
from sdtk_tpu.ops import fbank as jax_fbank
from sdtk_tpu.store import migrations as jax_migrations
from sdtk_tpu.utils import hashing as jax_hashing
from sdtk_tpu_torch.cli import common
from sdtk_tpu_torch.data import synth
from sdtk_tpu_torch.ops import cosine, fbank
from sdtk_tpu_torch.store import migrations
from sdtk_tpu_torch.utils import hashing

REPO = Path(__file__).resolve().parent.parent
# JAX-only plumbing, which the port has no use for: the TPU backend (the
# port's is backends/gpu.py), JAX's compile cache, and the Pallas kernels
# of ops/research/ (K1, K2 and K4 are the port's CUDA kernels).
JAX_ONLY_FILES = {"backends/tpu.py", "utils/jaxcache.py"}
JAX_ONLY_NAMES: dict[str, set[str]] = {}
# kernels the port names otherwise: K3 and the top-k's plain decomposition
RENAMED = {"ops/cosine.py": {"cosine_pallas": "cosine"},
           "ops/topk.py": {"identify_topk_xla": "identify_topk_plain"}}


def _public(path: Path) -> set[str]:
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def test_every_public_name_is_ported():
    """Each module of ``sdtk_tpu`` but the JAX-only ones has a port of the
    same path, holding every public name (or the port's name for it)."""
    missing = {}
    for f in sorted((REPO / "sdtk_tpu").rglob("*.py")):
        rel = f.relative_to(REPO / "sdtk_tpu").as_posix()
        if rel in JAX_ONLY_FILES or rel.startswith("ops/research/"):
            continue
        port = REPO / "sdtk_tpu_torch" / rel
        assert port.exists(), rel
        names = _public(port)
        renamed = RENAMED.get(rel, {})
        assert set(renamed.values()) <= names, rel
        gone = _public(f) - names - JAX_ONLY_NAMES.get(rel, set()) - set(renamed)
        if gone:
            missing[rel] = sorted(gone)
    assert missing == {}


@pytest.mark.parametrize("kind,versions", [("profile", range(0, 3)),
                                           ("sample_metadata", range(0, 4))])
def test_migration_plans_match_jax(kind, versions):
    for v in versions:
        assert migrations.get_migration_plan(kind, v) == jax_migrations.get_migration_plan(kind, v)


def test_needs_migration_and_description_match_jax(capsys):
    """``needs_migration`` on absent, lower, equal and higher versions;
    ``describe_migrations`` and the module's ``__main__`` print JAX's text."""
    for obj in ({}, {"version": 0}, {"version": 1}, {"version": 2}, {"version": 3}):
        for target in (1, 2):
            assert migrations.needs_migration(obj, target) == jax_migrations.needs_migration(
                obj, target)
    assert migrations.describe_migrations() == jax_migrations.describe_migrations()
    runpy.run_path(migrations.__file__, run_name="__main__")
    assert capsys.readouterr().out == jax_migrations.describe_migrations() + "\n"


@pytest.mark.parametrize("n", [0, 1, 63, 64, 1024, 1025, 4096, 10_000])
def test_blake3_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert hashing.blake3(data) == jax_hashing.blake3(data)


def test_compute_b3sum_full_matches_jax(tmp_path):
    f = tmp_path / "x.bin"
    f.write_bytes(np.random.default_rng(3).integers(0, 256, 70_000, dtype=np.uint8).tobytes())
    full = hashing.compute_b3sum_full(f)
    assert full == jax_hashing.compute_b3sum_full(f) and len(full) == 64
    assert hashing.compute_b3sum(f) == full[:32]


def test_synth_batch_and_test_voice_match_jax(tmp_path):
    """``synth_batch`` equals JAX's sample for sample; ``save_test_voice``
    writes the bytes JAX's writes."""
    spk, utt = np.array([0, 3, 7]), np.array([1, 0, 5])
    np.testing.assert_array_equal(synth.synth_batch(spk, utt, 1.5),
                                  jax_synth.synth_batch(spk, utt, 1.5))
    a = synth.save_test_voice(tmp_path / "a.wav", 4, 2, 1.0)
    b = jax_synth.save_test_voice(tmp_path / "b.wav", 4, 2, 1.0)
    assert a == tmp_path / "a.wav" and a.read_bytes() == Path(b).read_bytes()


def test_normalize_rows_and_top_k_scores_match_jax():
    """``normalize_rows`` within 1e-6; ``top_k_scores`` (over the plain
    version of the cosine kernel on the CPU) gives JAX's indices and its
    scores within 1e-6; k above N returns N."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((5, 24)).astype(np.float32)
    p = rng.standard_normal((40, 24)).astype(np.float32)
    q[1] = 0.0  # a zero row stays zero in both
    np.testing.assert_allclose(cosine.normalize_rows(torch.from_numpy(q)).numpy(),
                               np.asarray(jax_cosine.normalize_rows(jnp.asarray(q))), atol=1e-6)
    for k in (1, 3, 60):
        got_s, got_i = cosine.top_k_scores(torch.from_numpy(q), torch.from_numpy(p), k=k)
        want_s, want_i = jax_cosine.top_k_scores(jnp.asarray(q), jnp.asarray(p), k=k)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6)
        assert np.array_equal(got_i[[0, 2, 3, 4]].numpy(), np.asarray(want_i)[[0, 2, 3, 4]])
        assert got_s.shape == (5, min(k, 40))


@pytest.mark.parametrize("n,win,hop", [(16000, 400, 160), (1000, 400, 160), (400, 400, 160),
                                       (977, 100, 30), (50, 7, 7)])
def test_frame_signal_matches_jax(n, win, hop):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    got = fbank.frame_signal(torch.from_numpy(x), win, hop).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_fbank.frame_signal(jnp.asarray(x), win,
                                                                           hop)))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="cmd")
    sub.add_parser("list")
    own = sub.add_parser("check")
    own.add_argument("-v", "--verbose", action="store_true", help="its own")
    return p


@pytest.mark.parametrize("argv", [["list", "-v"], ["-q", "list"], ["list", "-q", "-v"],
                                  ["check", "-v"], ["-v", "check"], ["list"]])
def test_add_subcommand_flags_matches_jax(argv):
    got, want = _parser(), _parser()
    common.add_subcommand_flags(got)
    jax_common.add_subcommand_flags(want)
    assert vars(got.parse_args(argv)) == vars(want.parse_args(argv))
