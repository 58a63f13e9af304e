"""The port's jq evaluator (sdtk_tpu_torch/utils/jqlite.py) against the JAX
package's (sdtk_tpu/utils/jqlite.py): every filter that
tests/test_jqlite.py runs (read from that file's source, with its inputs),
the filters its CLI test queries profiles with, and the catalog ``query``
filters, through both packages' ``query_lines``.  One parametrized case a
filter: the output text must be equal, or both must raise ``JqError``
with the same message (the docstring path in two messages names each
package's own file)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from sdtk_tpu.utils import jqlite as jq
from sdtk_tpu_torch.utils import jqlite as pq

JAX_TESTS = Path(__file__).resolve().parent / "test_jqlite.py"

# Catalog entries as ``cli/catalog.py:cmd_query`` hands them to jq: the
# entry with its computed ``status``.
CATALOG = [
    {"recording": {"path": "/data/process-in/meeting-1.wav", "b3sum": "a" * 32,
                   "duration_sec": 24.9},
     "context": {"name": "standup", "expected_speakers": ["voice-0", "voice-1"]},
     "transcriptions": [{"backend": "tpu-diarize", "path": "/t/1.json"}],
     "tags": ["q1"], "status": "assigned"},
    {"recording": {"path": "/data/process-in/meeting-2.wav", "b3sum": "b" * 32,
                   "duration_sec": 25.1},
     "context": {"name": None}, "transcriptions": [], "tags": [], "status": "unprocessed"},
    {"recording": {"path": "/data/other/call.wav", "b3sum": "c" * 32, "duration_sec": 8.0},
     "context": {"name": "support"}, "transcriptions": [], "tags": ["call"],
     "status": "transcribed"},
]
CATALOG_FILTERS = [
    '.[] | select(.recording.path | startswith("/data/process-in/")) | .recording.b3sum',
    '[.[] | select(.recording.path | test("/process-in/meeting-[0-9]+\\\\.wav$"))] | length',
    '.[] | select(.status == "assigned") | .recording.path',
    'map(select(.context.name != null)) | map({ctx: .context.name, path: .recording.path})',
    'group_by(.status) | map({status: .[0].status, n: length})',
    '[.[].recording.duration_sec] | add',
    '.[] | select(.tags | contains(["call"])) | .recording.b3sum[0:8]',
    '.[] | "\\(.recording.b3sum[0:8]) \\(.status)"',
    '.[] | select(.transcriptions | length > 0) | .transcriptions[0].backend',
    'sort_by(.recording.duration_sec) | reverse | .[0].recording.path',
    '.[] | .context.expected_speakers // [] | length',
    '.[0].recording.missing.deeper',
    '.[] | .recording.path | ltrimstr("/data/") | split("/") | .[0]',
    '.[] | select(.status = "assigned")',  # assignment: unsupported, loud
]
# The profile filters of tests/test_jqlite.py:test_cli_query_wired, on a
# profile list as ``cli/detection.py query`` gives it.
PROFILES = [{"id": "zoe", "names": {"default": "Zoe"}, "tags": ["host"], "embeddings": {}}]
PROFILE_FILTERS = ['.[] | select(.id == "zoe") | .names.default', "reduce .[] as $x (0; .+1)",
                   ".a = 3"]


def _jax_test_cases() -> list[tuple[str, object]]:
    """(filter, input) of every ``query``/``query_lines`` call in
    tests/test_jqlite.py whose filter is a literal, or a loop variable over
    a tuple of literals; inputs evaluated with that file's module-level
    data."""
    tree = ast.parse(JAX_TESTS.read_text())
    env = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            env[node.targets[0].id] = ast.literal_eval(node.value)
    loops = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name) \
                and isinstance(node.iter, ast.Tuple):
            loops[node.target.id] = [ast.literal_eval(e) for e in node.iter.elts]
    cases = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("query", "query_lines") and len(node.args) == 2):
            continue
        expr, data = node.args
        value = eval(compile(ast.Expression(data), str(JAX_TESTS), "eval"), dict(env))
        if isinstance(expr, ast.Constant):
            cases.append((expr.value, value))
        elif isinstance(expr, ast.Name) and expr.id in loops:
            cases += [(f, value) for f in loops[expr.id]]
    return sorted(cases, key=lambda c: (c[0], repr(c[1])))


CASES = ([(f, d, "test_jqlite") for f, d in _jax_test_cases()]
         + [(f, CATALOG, "catalog") for f in CATALOG_FILTERS]
         + [(f, PROFILES, "profiles") for f in PROFILE_FILTERS])


def test_every_filter_of_the_jax_tests_is_a_case():
    """The source walk finds every filter: 100 and more calls in that file
    (none is silently dropped), the unsupported-syntax loop's seven
    among them."""
    found = _jax_test_cases()
    assert len(found) >= 100
    assert {"$undefined_var", ".a = 3", ".a |= 3", "..", "@base64", "nosuchfn(.)",
            ". as [$a] | $a"} <= {f for f, _ in found}


def _run(mod, expr: str, data):
    try:
        return ("out", mod.query_lines(expr, data))
    except mod.JqError as e:
        return ("JqError", str(e).replace("sdtk_tpu_torch/", "sdtk_tpu/"))


@pytest.mark.parametrize("expr,data,origin", CASES,
                         ids=[f"{o}:{i}" for i, (_, _, o) in enumerate(CASES)])
def test_query_lines_matches_jax(expr, data, origin):
    want = _run(jq, expr, data)
    assert _run(pq, expr, data) == want
    if want[0] == "out":  # and the values themselves, before JSON
        assert pq.query(expr, data) == jq.query(expr, data)
