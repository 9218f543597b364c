"""RULEGEN — hand-crafted linguistic-uncertainty rules (paper §III-B).

Reproduces the paper's rule generator: the input text is tokenized and
PoS-tagged (spaCy in the paper; a self-contained lexicon PoS-lite here,
since the container is offline), then six uncertainty intensities are
measured by searching for pre-defined patterns — Listing 1 of the paper
shows the vague-expression rule; the other five follow the same recipe
from the cited literature (Table I).

``rulegen(text)`` returns the 6-vector of intensities
(structural, syntactic, semantic, vague, open_ended, multi_part);
``features(text)`` appends the input length (the paper's fallback signal
for sentences with none of the six sources, Fig. 2a/2e).
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

# ---------------------------------------------------------------------------
# tokenizer + PoS-lite lexicon
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"[a-zA-Z']+|[?.,!;:]")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


# words whose lexicon entry carries >1 PoS tag (syntactic ambiguity)
MULTI_POS = {
    "flies": ("NOUN", "VERB"), "like": ("VERB", "ADP"),
    "watch": ("NOUN", "VERB"), "duck": ("NOUN", "VERB"),
    "saw": ("NOUN", "VERB"), "rounds": ("NOUN", "VERB"), "park": ("NOUN", "VERB"),
    "train": ("NOUN", "VERB"), "book": ("NOUN", "VERB"),
    "plant": ("NOUN", "VERB"), "play": ("NOUN", "VERB"),
    "runs": ("NOUN", "VERB"),
    "walks": ("NOUN", "VERB"), "files": ("NOUN", "VERB"),
    "races": ("NOUN", "VERB"), "cooks": ("NOUN", "VERB"),
    "fly": ("NOUN", "VERB"), "face": ("NOUN", "VERB"),
    "hand": ("NOUN", "VERB"), "man": ("NOUN", "VERB"),
    "dust": ("NOUN", "VERB"), "seed": ("NOUN", "VERB"),
    "sand": ("NOUN", "VERB"), "water": ("NOUN", "VERB"),
    "rice": ("NOUN", "ADJ"),
}

# polysemy lexicon: word -> number of common senses (semantic ambiguity)
POLYSEMOUS: Dict[str, int] = {
    "bat": 3, "bats": 3, "trunk": 4, "monitor": 3, "bank": 3, "banks": 3,
    "spring": 4, "pitch": 4, "crane": 3, "seal": 3, "bolt": 3, "chest": 2,
    "club": 3, "court": 3, "date": 3, "draft": 4, "fair": 3, "jam": 3,
    "letter": 2, "match": 3, "mine": 2, "nail": 2, "organ": 2, "palm": 2,
    "pool": 3, "pupil": 2, "ring": 3, "rock": 3, "scale": 4, "tie": 3,
    "wave": 3, "well": 3, "cell": 3, "mouse": 2, "virus": 2, "bug": 3,
    "table": 2, "key": 3, "note": 3, "bar": 4, "board": 3, "cap": 3,
    "light": 3, "mole": 3, "port": 3, "present": 3, "racket": 2,
}

PREPOSITIONS = {"in", "on", "at", "with", "by", "near", "under", "over",
                "behind", "beside", "from", "through", "across", "about"}
DETERMINERS = {"a", "an", "the", "this", "that", "these", "those", "my",
               "your", "his", "her", "its", "our", "their", "some"}
WH_WORDS = {"what", "why", "how", "when", "where", "who", "which", "whose"}
CONJ = {"and", "or"}

# Listing-1 style lexicons for the vague-expression rule
VAGUE_NOUNS = {"history", "nature", "concept", "idea", "meaning", "essence",
               "philosophy", "culture", "society", "art", "life", "things",
               "stuff", "future", "past", "world", "universe", "role",
               "impact", "significance", "importance", "state", "notion"}
VAGUE_ADJS = {"general", "broad", "various", "overall", "abstract", "vague",
              "complex", "global", "universal", "fundamental", "big",
              "whole", "entire", "many", "several", "countless", "endless"}
VAGUE_QUANT = {"some", "many", "much", "lots", "plenty", "several",
               "a lot of", "kind of", "sort of", "somewhat"}
OPEN_HEADS = {"causes", "consequences", "implications", "effects",
              "significance", "meaning", "purpose", "origins", "reasons",
              "future", "pros", "cons", "benefits", "drawbacks",
              "advantages", "disadvantages"}
OPINION_PAT = re.compile(
    r"\b(what do you think|do you think|your (opinion|view|thoughts)|"
    r"in your opinion|how do you feel)\b")
VAGUE_OF_PAT = re.compile(
    r"\b(tell me|talk|tell us|know|learn|hear) (\w+ ){0,2}about\b|"
    r"\b(history|nature|concept|meaning|philosophy|essence|idea|future|"
    r"state|role|impact) of\b")


def _pos_tags(tokens: List[str]) -> List[str]:
    tags = []
    for i, t in enumerate(tokens):
        if t in DETERMINERS:
            tags.append("DET")
        elif t in PREPOSITIONS:
            tags.append("ADP")
        elif t in WH_WORDS:
            tags.append("WH")
        elif t in CONJ:
            tags.append("CCONJ")
        elif t in ("?", ".", ",", "!", ";", ":"):
            tags.append("PUNCT")
        elif t in MULTI_POS:
            tags.append("AMBIG")
        elif t.endswith("ing") or t.endswith("ed") or t in (
                "is", "are", "was", "were", "be", "do", "does", "did",
                "can", "could", "should", "would", "will", "tell", "saw",
                "differ", "deal", "think", "know", "talk", "eat", "love"):
            tags.append("VERB")
        elif t.endswith("ly"):
            tags.append("ADV")
        elif t in VAGUE_ADJS:
            tags.append("ADJ")
        else:
            tags.append("NOUN")
    return tags


# ---------------------------------------------------------------------------
# the six rules
# ---------------------------------------------------------------------------


def structural_score(tokens, tags) -> float:
    """PP-attachment ambiguity: >=2 prepositional phrases after a verb can
    each attach to the verb or a preceding NP ('saw a boy in the park with
    a telescope')."""
    if "VERB" not in tags and "AMBIG" not in tags:
        return 0.0
    first_v = min((i for i, t in enumerate(tags)
                   if t in ("VERB", "AMBIG")), default=len(tags))
    pps = [i for i, t in enumerate(tags[first_v + 1:], first_v + 1)
           if t == "ADP"]
    # each PP beyond the first has >=2 attachment sites
    score = max(0, len(pps) - 1) * 2.0
    # coordination right after an NP adds bracketing readings
    score += sum(1.0 for i in pps if i + 2 < len(tags)
                 and tags[i + 1] == "DET" and tags[i + 2] == "NOUN") * 0.5
    return score


def syntactic_score(tokens, tags) -> float:
    """Words carrying multiple PoS tags ('Rice flies like sand')."""
    n = sum(1.0 for t in tokens if t in MULTI_POS)
    # adjacent ambiguous words multiply the parse count
    runs = sum(1.0 for a, b in zip(tokens, tokens[1:])
               if a in MULTI_POS and b in MULTI_POS)
    return n + runs


def semantic_score(tokens, tags) -> float:
    """Polysemous words, weighted by (senses - 1)."""
    return float(sum(POLYSEMOUS.get(t, 1) - 1 for t in tokens))


def vague_score(text, tokens, tags) -> float:
    """Listing 1: PoS-tagged tokens + regex patterns for broad concepts."""
    score = 0.0
    if VAGUE_OF_PAT.search(text.lower()):
        score += 2.0
    score += sum(1.0 for t in tokens if t in VAGUE_NOUNS) * 0.8
    score += sum(1.0 for t in tokens if t in VAGUE_ADJS) * 0.6
    score += sum(0.4 for q in VAGUE_QUANT if q in text.lower())
    return score


def open_score(text, tokens, tags) -> float:
    """Open-ended questions lacking a single definitive answer."""
    tl = text.lower()
    score = 0.0
    if tokens and tokens[0] in ("why", "how"):
        score += 1.5
    if re.search(r"\bwhat (are|is) the\b", tl):
        score += 0.5
    score += sum(1.2 for h in OPEN_HEADS if h in tokens)
    if OPINION_PAT.search(tl):
        score += 1.5
    if "?" in text and not any(
            t in tokens for t in ("when", "where", "who")):
        score += 0.3
    return score


def multipart_score(text, tokens, tags) -> float:
    """Multiple sub-questions / enumerated topics demanding each an answer."""
    score = 0.0
    score += text.count("?") - 1 if text.count("?") > 1 else 0
    # 'X and Y' coordinations
    coords = sum(1.0 for a, b in zip(tags, tags[1:] + ["PUNCT"])
                 if a == "CCONJ")
    score += max(0.0, coords - 0.0) * 0.8
    # comma enumerations: 'A, B, and C'
    commas = tokens.count(",")
    if commas >= 1 and coords >= 1:
        score += commas * 0.8
    if re.search(r"\bdiffer in\b|\bcompare\b|\bboth\b|respectively",
                 text.lower()):
        score += 1.0
    return score


UNCERTAINTY_TYPES = ("structural", "syntactic", "semantic", "vague",
                     "open_ended", "multi_part")


def rulegen(text: str) -> np.ndarray:
    """The paper's RULEGEN(J): 6-vector of uncertainty intensities."""
    tokens = tokenize(text)
    tags = _pos_tags(tokens)
    return np.array([
        structural_score(tokens, tags),
        syntactic_score(tokens, tags),
        semantic_score(tokens, tags),
        vague_score(text, tokens, tags),
        open_score(text, tokens, tags),
        multipart_score(text, tokens, tags),
    ], dtype=np.float32)


def input_length(text: str) -> float:
    return float(len(tokenize(text)))


def features(text: str) -> np.ndarray:
    """6 rule scores + input length (the fallback channel of Fig. 2a/2e)."""
    return np.concatenate([rulegen(text),
                           [input_length(text)]]).astype(np.float32)


FEATURE_DIM = 7


def single_rule_score(text: str) -> float:
    """Paper §III-B 'single rule': the dominant rule intensity, falling
    back to input length when no uncertainty pattern fires."""
    r = rulegen(text)
    if r.max() <= 0:
        return input_length(text)
    return float(r.max())


def weighted_rule_score(text: str, weights: np.ndarray) -> float:
    """Paper §III-B 'weighted rule': linear blend fitted offline."""
    r = features(text)
    return float(r @ weights[:FEATURE_DIM])
