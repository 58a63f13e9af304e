"""The port's transcript layer (``sdtk_tpu_torch/transcripts``) against the
JAX package's: format detection, speaker labels, run-length segments,
merge-and-filter, the segment array and the recursive label mapper must
be equal (exact: the code is host Python with no arithmetic of its own
beyond ms → s), on reference-shaped AssemblyAI and Speechmatics
documents and their edge cases."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest

from sdtk_tpu import transcripts as jt
from sdtk_tpu.store import profiles as jprofiles
from sdtk_tpu.transcripts import mapper as jmapper
from sdtk_tpu_torch import transcripts as pt
from sdtk_tpu_torch.store import profiles as pprofiles
from sdtk_tpu_torch.transcripts import mapper as pmapper

ASSEMBLYAI_2SPK = {
    "utterances": [
        {"speaker": "A", "start": 1000, "end": 5000, "text": "Hello everyone, this is the host"},
        {"speaker": "B", "start": 6000, "end": 10000, "text": "Hi, second voice here"},
        {"speaker": "A", "start": 11000, "end": 15000, "text": "How is the project going?"},
        {"speaker": "B", "start": 16000, "end": 20000, "text": "Making good progress"},
        {"speaker": "A", "start": 21000, "end": 25000, "text": "Great, let me know"},
    ]
}


def _word(t0, t1, speaker=None, content="w", alt_speaker=None, kind="word"):
    item = {"type": kind, "start_time": t0, "end_time": t1,
            "alternatives": [{"content": content}]}
    if speaker is not None:
        item["speaker"] = speaker
    if alt_speaker is not None:
        item["alternatives"][0]["speaker"] = alt_speaker
    return item


SPEECHMATICS_2SPK = {
    "results": [
        _word(1.0, 2.0, "S1", "Hello", "S1"),
        _word(2.5, 3.5, "S2", "Hi", "S2"),
        _word(4.0, 5.0, "S1", "Good", "S1"),
    ]
}

# Speaker only inside the alternatives, punctuation between runs, a word
# with no speaker (→ "UU"), short runs dropped before the merge decision
# (0.3 s < 0.5 s) and runs that merge across a gap ≤ 1 s.
SPEECHMATICS_EDGES = {
    "results": [
        _word(0.0, 0.4, alt_speaker="S1", content="Hi"),
        _word(0.4, 1.2, alt_speaker="S1", content="there"),
        _word(1.2, 1.2, content=",", kind="punctuation"),
        _word(1.5, 1.8, "S2", "yes"),
        _word(2.0, 2.9, "S1", "so"),
        _word(3.0, 3.4, content="um"),
        _word(3.6, 4.5, "S1", "anyway"),
        _word(6.0, 6.3, "S2", "ok"),
        _word(6.3, 7.4, "S2", "sure"),
    ]
}

# Items without a "type" field count as words; a non-list "results" and
# utterances without a speaker.
SPEECHMATICS_UNTYPED = {
    "results": [
        {"start_time": 0.0, "end_time": 0.9, "alternatives": [{"content": "a", "speaker": "S2"}]},
        {"start_time": 1.0, "end_time": 1.9, "alternatives": [{"content": "b", "speaker": "S2"}]},
        {"start_time": 2.0, "end_time": 3.1, "speaker": "S3", "alternatives": [{"content": "c"}]},
    ]
}
ASSEMBLYAI_EDGES = {
    "utterances": [
        {"speaker": "A", "start": 0, "end": 300, "text": "Hm"},
        {"start": 300, "end": 900, "text": "(no speaker)"},
        {"speaker": "A", "start": 900, "end": 2500, "text": "Right"},
        {"speaker": "C", "start": 4000, "end": 4200, "text": ""},
    ]
}
UNKNOWN = {"results": {"not": "a list"}, "speaker": "X"}

FIXTURES = {
    "assemblyai": ASSEMBLYAI_2SPK,
    "speechmatics": SPEECHMATICS_2SPK,
    "speechmatics-edges": SPEECHMATICS_EDGES,
    "speechmatics-untyped": SPEECHMATICS_UNTYPED,
    "assemblyai-edges": ASSEMBLYAI_EDGES,
    "unknown": UNKNOWN,
}


def _everything(pkg, mapper, doc):
    """Every output of the transcript layer for one document."""
    labels = pkg.get_available_speakers(doc)
    out = {"format": pkg.detect_transcript_format(doc), "labels": labels,
           "json_speakers": sorted(mapper.detect_speakers_in_json(doc)),
           "mapped": mapper.replace_speakers_recursive(
               doc, {lab: f"name-{i}" for i, lab in enumerate(labels)})}
    for lab in labels + ["UU", "nobody"]:
        tuples = pkg.extract_segments_as_tuples(doc, lab)
        out[lab] = {
            "tuples": tuples,
            "speaker_segments": pkg.get_speaker_segments(doc, lab),
            "merged": pkg.extract_segments_from_transcript(doc, lab),
            "merged_tight": pkg.extract_segments_from_transcript(doc, lab, 0.0, 0.0),
            "merged_wide": pkg.extract_segments_from_transcript(doc, lab, 0.25, 3.0),
            "gap_merged": pkg.merge_segments_by_gap(tuples, 1.5),
            "array": pkg.segments_to_array(tuples).tolist(),
            "dict_array": pkg.segments_to_array(pkg.get_speaker_segments(doc, lab)).tolist(),
        }
    return out


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_transcript_layer_matches_jax(name, tmp_path):
    doc = FIXTURES[name]
    before = copy.deepcopy(doc)
    got = _everything(pt, pmapper, doc)
    want = _everything(jt, jmapper, doc)
    assert got == want
    assert doc == before  # neither package mutates its input
    path = tmp_path / "t.json"
    path.write_text(json.dumps(doc))
    assert pt.load_transcript(path) == jt.load_transcript(path) == doc
    if name == "assemblyai":  # ms → s (reference transcript.py)
        assert got["A"]["tuples"] == [(1.0, 5.0), (11.0, 15.0), (21.0, 25.0)]
    if name == "speechmatics-edges":  # S2's 0.3 s run drops before the merge decision
        assert got["S1"]["merged"] == [{"start": 0.0, "end": 4.5, "text": "Hi there so anyway"}]
        assert got["S2"]["merged"] == [{"start": 6.0, "end": 7.4, "text": "ok sure"}]
        assert "UU" not in got["labels"] and got["UU"]["tuples"] == [(3.0, 3.4)]
    assert pt.segments_to_array([]).dtype == np.float32


def test_mapper_applies_assignments_like_jax(tmp_path, monkeypatch):
    """``apply_assignments_to_transcript`` reads names from the profile
    store: both packages write the same mapped document from one store."""
    monkeypatch.setenv("SPEAKERS_EMBEDDINGS_DIR", str(tmp_path / "store"))
    pprofiles.save_speaker(pprofiles.create_speaker_profile("alice", "Alice Smith"))
    src = tmp_path / "t.json"
    src.write_text(json.dumps(SPEECHMATICS_2SPK))
    assignments = {"mappings": {"S1": {"speaker_id": "alice"},
                                "S2": {"speaker_id": "ghost"},
                                "S3": {"speaker_id": None}}}
    for use_names in (True, False):
        assert (pmapper.mapping_from_assignments(assignments, use_names)
                == jmapper.mapping_from_assignments(assignments, use_names))
        port_out, jax_out = tmp_path / f"p{use_names}.json", tmp_path / f"j{use_names}.json"
        got = pmapper.apply_assignments_to_transcript(src, assignments, port_out, use_names)
        want = jmapper.apply_assignments_to_transcript(src, assignments, jax_out, use_names)
        assert got == want
        assert port_out.read_bytes() == jax_out.read_bytes()
    assert jprofiles.load_speaker("alice")["names"]["default"] == "Alice Smith"
    assert got["results"][0]["speaker"] == "alice" and got["results"][1]["speaker"] == "ghost"
