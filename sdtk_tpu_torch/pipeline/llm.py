"""LLM speaker-name detection — the third assignment signal (a copy of
``sdtk_tpu/pipeline/llm.py``: the same providers, prompt, parsing, cache
keys and offline pattern provider, so both packages fire the same
signals).  Host code only; the provider clients are imported when used.

Port of reference ``speaker-llm``'s behavioral surface: provider registry
(anthropic → openai → ollama auto-priority, :312-324), conversation
flattening to ``[S1]: text`` lines (:130-168), the 6 detection patterns in
the analysis prompt (:67-74), markdown-fence-tolerant JSON parsing
(:402-426), and a content-hash response cache (:77-94).

Additions: a ``pattern`` provider — offline regex detection of
self-introductions and direct address — which is both the test double and
a zero-dependency fallback signal (this environment has no egress).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

from .. import config
from ..transcripts import detect_transcript_format, get_available_speakers, load_transcript
from ..utils.ioutil import atomic_write_text

DEFAULT_MODELS = {
    "anthropic": "claude-3-haiku-20240307",
    "openai": "gpt-4o-mini",
    "ollama": "llama3.2",
    "pattern": "regex-v1",
}

ENV_VARS = {
    "anthropic": "ANTHROPIC_API_KEY",
    "openai": "OPENAI_API_KEY",
    "ollama": "OLLAMA_HOST",
}

DEFAULT_OLLAMA_HOST = "http://localhost:11434"

DETECTION_PATTERNS = """
1. Direct address: "Alice, can you...", "Hey Bob, what about..."
2. Self-reference: "I'm Bob and I think...", "This is Alice speaking"
3. Third-person mention: "As Carol mentioned...", "I agree with what Dave said"
4. Introduction: "Hi, this is Dave", "My name is Eve"
5. Role-based: "The host John...", "Our guest Dr. Smith..."
6. Conversation flow: When someone says "Thanks, [name]" after another speaker
"""


def extract_conversation_text(data: dict[str, Any]) -> str:
    """Flatten a transcript to '[label]: text' lines (reference :130-168)."""
    fmt = detect_transcript_format(data)
    lines: list[str] = []
    if fmt == "assemblyai":
        for u in data.get("utterances", []):
            text = u.get("text", "")
            if text:
                lines.append(f"[{u.get('speaker', '?')}]: {text}")
    elif fmt == "speechmatics":
        cur_speaker, cur_text = None, []
        for r in data.get("results", []):
            speaker, word = None, ""
            for alt in r.get("alternatives", []):
                if alt.get("speaker"):
                    speaker = alt["speaker"]
                if alt.get("content"):
                    word = alt["content"]
            if r.get("speaker"):
                speaker = r["speaker"]
            if speaker and speaker != cur_speaker:
                if cur_speaker and cur_text:
                    lines.append(f"[{cur_speaker}]: {' '.join(cur_text)}")
                cur_speaker, cur_text = speaker, []
            if word:
                cur_text.append(word)
        if cur_speaker and cur_text:
            lines.append(f"[{cur_speaker}]: {' '.join(cur_text)}")
    return "\n".join(lines)


def build_analysis_prompt(conversation_text: str, speaker_labels: list[str]) -> str:
    return f"""Analyze this conversation transcript and identify the names of the speakers.

SPEAKERS TO IDENTIFY: {', '.join(speaker_labels)}

DETECTION PATTERNS TO LOOK FOR:
{DETECTION_PATTERNS}

CONVERSATION:
{conversation_text}

INSTRUCTIONS:
1. For each speaker label, determine if their name is mentioned or can be inferred
2. Provide confidence (0.0-1.0) based on evidence strength
3. List specific quotes that support your identification

Respond in JSON format:
{{
    "detections": [
        {{
            "speaker_label": "S1",
            "detected_name": "Alice" or null,
            "confidence": 0.85,
            "evidence": ["Quote 1 that reveals name", "Quote 2..."]
        }}
    ],
    "notes": "Any additional observations"
}}

Only respond with the JSON, no other text."""


def parse_llm_response(response_text: str) -> dict[str, Any]:
    """Markdown-fence and prose tolerant JSON parse (reference :402-426)."""
    text = response_text.strip()
    if text.startswith("```"):
        lines = text.split("\n")
        if lines[0].startswith("```"):
            lines = lines[1:]
        if lines and lines[-1].strip() == "```":
            lines = lines[:-1]
        text = "\n".join(lines)
    start = text.find("{")
    if start >= 0:
        return json.loads(text[start:])
    return json.loads(text)


# ---------------------------------------------------------------------------
# Providers
# ---------------------------------------------------------------------------


class Provider:
    name = "base"

    def available(self) -> bool:
        return False

    def complete(self, prompt: str, model: str | None = None) -> str:
        raise NotImplementedError


class AnthropicProvider(Provider):
    name = "anthropic"

    def available(self) -> bool:
        if not os.environ.get(ENV_VARS["anthropic"]):
            return False
        try:
            import anthropic  # noqa: F401
        except ImportError:
            return False
        return True

    def complete(self, prompt: str, model: str | None = None) -> str:
        import anthropic

        client = anthropic.Anthropic()
        resp = client.messages.create(
            model=model or DEFAULT_MODELS["anthropic"],
            max_tokens=2048,
            messages=[{"role": "user", "content": prompt}],
        )
        return resp.content[0].text


class OpenAIProvider(Provider):
    name = "openai"

    def available(self) -> bool:
        if not os.environ.get(ENV_VARS["openai"]):
            return False
        try:
            import openai  # noqa: F401
        except ImportError:
            return False
        return True

    def complete(self, prompt: str, model: str | None = None) -> str:
        import openai

        client = openai.OpenAI()
        resp = client.chat.completions.create(
            model=model or DEFAULT_MODELS["openai"],
            messages=[{"role": "user", "content": prompt}],
        )
        return resp.choices[0].message.content or ""


class OllamaProvider(Provider):
    name = "ollama"

    def available(self) -> bool:
        import urllib.request

        host = os.environ.get(ENV_VARS["ollama"], DEFAULT_OLLAMA_HOST)
        try:
            urllib.request.urlopen(f"{host}/api/tags", timeout=2)
            return True
        except Exception:
            return False

    def complete(self, prompt: str, model: str | None = None) -> str:
        import urllib.request

        host = os.environ.get(ENV_VARS["ollama"], DEFAULT_OLLAMA_HOST)
        req = urllib.request.Request(
            f"{host}/api/generate",
            data=json.dumps(
                {"model": model or DEFAULT_MODELS["ollama"], "prompt": prompt,
                 "stream": False}
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.loads(resp.read())["response"]


# Self-introduction / address regexes for the offline provider.
_NAME = r"([A-Z][a-z]+(?:\s[A-Z][a-z]+)?)"
_TITLED = r"((?:Mr|Ms|Mrs|Dr|Prof)\.?\s[A-Z][a-z]+)"
_SELF_PATTERNS = [
    re.compile(rf"\bI'?m\s+{_NAME}\b"),
    re.compile(rf"\b[Mm]y name is\s+{_NAME}\b"),
    re.compile(rf"\b[Tt]his is\s+{_NAME}\b"),
    re.compile(rf"\bcalls? me\s+{_NAME}\b"),  # "everyone calls me Kate"
]
_ADDRESS_PATTERNS = [  # name of whoever speaks NEXT
    re.compile(rf"^{_NAME},"),  # "Bob, can you..."
    re.compile(rf"^{_TITLED},"),  # "Mr. Calloway, you had..."
    re.compile(rf"\b(?:[Hh]ey|[Hh]i)\s+{_NAME}\b"),
    re.compile(rf"\byou,?\s+{_NAME}\b"),  # "over to you, Henrik"
]
_THANKS_PATTERN = re.compile(rf"\b[Tt]hanks,?\s+{_NAME}\b")  # PREVIOUS speaker
_STOPWORDS = {
    # interjections/discourse words that start sentences and would otherwise
    # match the "^Name," direct-address pattern
    "Hi", "Hey", "Hello", "Thanks", "Thank", "Ok", "Okay", "Yes", "No", "So",
    "Well", "I", "Welcome", "Right", "Sure", "Sorry", "Great", "Perfect",
    "Understood", "Agreed", "Excellent", "Exactly", "Absolutely", "Alright",
    "Anyway", "Also", "Now", "Next", "First", "Second", "Finally", "Again",
    "Good", "Fine", "Wait", "Look", "Listen", "Please", "Correct", "Indeed",
}
_SENTENCE_SPLIT = re.compile(r"(?<=[.!?])\s+")


class PatternProvider(Provider):
    """Offline deterministic detector.

    Self-introductions attribute a name to the *speaking* label; direct
    address attributes the name to the label of the *next different*
    speaker line (conversation-flow heuristic #6).
    """

    name = "pattern"

    def available(self) -> bool:
        return True

    def analyze(self, conversation_text: str, labels: list[str]) -> dict[str, Any]:
        lines = [
            m.groups() for m in (
                re.match(r"\[([^\]]+)\]:\s*(.*)", ln)
                for ln in conversation_text.splitlines()
            ) if m
        ]
        votes: dict[str, dict[str, list[str]]] = {l: {} for l in labels}

        def vote(label: str, name: str, quote: str):
            if label in votes and name not in _STOPWORDS:
                votes[label].setdefault(name, []).append(quote)

        for i, (label, text) in enumerate(lines):
            def prev_label():
                for plabel, _ in reversed(lines[:i]):
                    if plabel != label:
                        return plabel
                return None

            def next_label():
                for nlabel, _ in lines[i + 1 :]:
                    if nlabel != label:
                        return nlabel
                return None

            for pat in _SELF_PATTERNS:
                for m in pat.finditer(text):
                    vote(label, m.group(1), text)
            for m in _THANKS_PATTERN.finditer(text):
                # "Thanks, Alice" after Alice spoke → previous speaker
                p = prev_label()
                if p:
                    vote(p, m.group(1), text)
            for sentence in _SENTENCE_SPLIT.split(text):
                for pat in _ADDRESS_PATTERNS:
                    for m in pat.finditer(sentence.strip()):
                        nxt = next_label()
                        if nxt:
                            vote(nxt, m.group(1), text)

        detections = []
        for label in labels:
            if votes.get(label):
                name, quotes = max(votes[label].items(), key=lambda kv: len(kv[1]))
                conf = min(0.95, 0.6 + 0.15 * (len(quotes) - 1))
                detections.append(
                    {
                        "speaker_label": label,
                        "detected_name": name,
                        "confidence": conf,
                        "evidence": quotes[:3],
                    }
                )
            else:
                detections.append(
                    {
                        "speaker_label": label,
                        "detected_name": None,
                        "confidence": 0.0,
                        "evidence": [],
                    }
                )
        return {"detections": detections, "notes": "pattern provider (offline regex)"}

    def complete(self, prompt: str, model: str | None = None) -> str:
        raise NotImplementedError("pattern provider is structural, not prompt-based")


PROVIDERS: dict[str, Provider] = {
    "anthropic": AnthropicProvider(),
    "openai": OpenAIProvider(),
    "ollama": OllamaProvider(),
    "pattern": PatternProvider(),
}


class ProviderUnavailableError(RuntimeError):
    pass


def select_provider(name: str | None = None) -> Provider:
    """Explicit name (must be available, reference :312-324), else priority
    anthropic → openai → ollama.  The offline ``pattern`` provider is only
    used when explicitly requested — auto-selection with no configured
    provider errors like the reference does."""
    if name:
        if name not in PROVIDERS:
            raise ValueError(f"unknown provider '{name}'")
        prov = PROVIDERS[name]
        if not prov.available():
            env = ENV_VARS.get(name)
            hint = f" (set {env})" if env else ""
            raise ProviderUnavailableError(
                f"Provider '{name}' not available{hint}"
            )
        return prov
    for candidate in ("anthropic", "openai", "ollama"):
        if PROVIDERS[candidate].available():
            return PROVIDERS[candidate]
    raise ProviderUnavailableError(
        "No LLM provider available. Set ANTHROPIC_API_KEY or OPENAI_API_KEY, "
        "run an Ollama server, or pass --provider pattern for the offline "
        "regex provider."
    )


def list_providers() -> list[dict[str, Any]]:
    return [
        {
            "name": p.name,
            "available": p.available(),
            "default_model": DEFAULT_MODELS.get(p.name),
            "env_var": ENV_VARS.get(p.name),
        }
        for p in PROVIDERS.values()
    ]


# ---------------------------------------------------------------------------
# Cache (reference :77-94,448-457)
# ---------------------------------------------------------------------------


def _cache_key(text: str, provider: str, model: str | None) -> str:
    h = hashlib.sha256(f"{provider}:{model}:{text}".encode()).hexdigest()[:16]
    return h


def _cache_path(key: str) -> Path:
    d = config.llm_cache_dir()
    d.mkdir(parents=True, exist_ok=True)
    return d / f"{key}.json"


def clear_cache() -> int:
    d = config.llm_cache_dir()
    n = 0
    if d.exists():
        for f in d.glob("*.json"):
            f.unlink()
            n += 1
    return n


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------


def analyze_transcript(
    transcript: str | Path | dict[str, Any],
    provider: str | None = None,
    model: str | None = None,
    context: str | None = None,
    use_cache: bool = True,
) -> dict[str, Any]:
    """Full name analysis; returns {"detections": [...], "notes",
    "provider", "model", "cached"}."""
    data = transcript if isinstance(transcript, dict) else load_transcript(transcript)
    labels = get_available_speakers(data)
    text = extract_conversation_text(data)

    prov = select_provider(provider)
    key = _cache_key(text, prov.name, model)
    cpath = _cache_path(key)
    if use_cache and cpath.exists():
        cached = json.loads(cpath.read_text())
        cached["cached"] = True
        return cached

    if isinstance(prov, PatternProvider):
        result = prov.analyze(text, labels)
    else:
        raw = prov.complete(build_analysis_prompt(text, labels), model)
        result = parse_llm_response(raw)

    result.setdefault("detections", [])
    result["provider"] = prov.name
    result["model"] = model or DEFAULT_MODELS.get(prov.name)
    result["processed_at"] = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
    result["cached"] = False
    if use_cache:
        atomic_write_text(cpath, json.dumps(result, indent=2))
    return result


def detect_names(
    transcript: str | Path | dict[str, Any],
    provider: str | None = None,
    model: str | None = None,
    use_cache: bool = True,
) -> dict[str, str | None]:
    """Quick mode: {label: name|None} (reference :498-559)."""
    analysis = analyze_transcript(transcript, provider, model, use_cache=use_cache)
    return {
        d["speaker_label"]: d.get("detected_name")
        for d in analysis.get("detections", [])
    }
