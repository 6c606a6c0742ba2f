"""Context-cue phrase extraction.

The reference parses the VSM's common-sense answer with spaCy dependency
trees to pull out the location noun chunk (visual_search.py:54-112). spaCy
is used when importable; otherwise a lightweight heuristic extracts the
head noun phrase. The context-cue path only triggers when the target-cue
heatmap is weak, so the fallback costs little accuracy.
"""

from __future__ import annotations

import re
from typing import List

try:  # pragma: no cover - environment dependent
    import spacy
    try:
        _NLP = spacy.load("en_core_web_sm")
    except Exception:
        _NLP = None
except Exception:  # pragma: no cover
    spacy = None
    _NLP = None

_DETS = {"the", "a", "an", "this", "that", "these", "those", "some",
         "any", "its", "their", "his", "her", "your", "my", "our"}
_PREPS = {"on", "in", "at", "near", "by", "under", "over", "above",
          "below", "behind", "beside", "inside", "outside", "within",
          "around", "next", "to", "of", "with", "along", "against",
          "across", "between", "among", "atop", "onto", "upon",
          "towards", "toward", "beneath", "underneath"}
_ADVS = {"most", "likely", "probably", "usually", "typically", "often",
         "somewhere", "generally", "commonly", "perhaps", "possibly",
         "right", "just", "directly", "closely", "very"}
_COPULA = {"is", "are", "be", "was", "were", "would", "could", "should",
           "can", "may", "might", "will"}
_VERBALS = {"hanging", "placed", "located", "found", "sitting", "standing",
            "mounted", "stored", "kept", "displayed", "parked", "resting",
            "positioned", "situated", "attached", "hung", "lying",
            "leaning", "appear", "appearing", "seen", "spotted"}
_CONJ = {"or", "and", "nor"}
# leading function words stripped from each coordinated segment; the rest
# of the segment (including internal prepositional phrases, which spaCy
# merges into the head noun's subtree via the 'prep' dep) is the chunk
_STRIPPABLE = _DETS | _PREPS | _ADVS | _COPULA | _VERBALS | {"it", ","}
# words that are function words only in adverbial/auxiliary position but
# content words when heading a noun phrase ('right side', 'can of soda');
# spaCy resolves this via POS — the heuristic keeps them when the next
# word is a content word (amod attachment) or 'of' (noun + prep)
_AMBIG = {"right", "can", "may", "might", "will"}


def _spacy_noun_chunks(expression: str) -> List[str]:
    doc = _NLP(expression)

    def traverse(token):
        lo = hi = token.i
        for child in token.children:
            clo, chi = traverse(child)
            lo, hi = min(lo, clo), max(hi, chi)
        return lo, hi

    def chunk_span(token):
        left = [c for c in token.children if c.i < token.i]
        right = [c for c in token.children if c.i > token.i]
        start = end = token.i
        for lc in left[::-1]:
            if lc.dep_ in ("amod", "compound", "poss"):
                start, _ = traverse(lc)
            else:
                break
        for rc in right:
            if rc.dep_ in ("relcl", "prep"):
                _, end = traverse(rc)
            else:
                break
        return start, end

    spans = [chunk_span(t) for t in doc if t.pos_ in ("NOUN", "PRON")]
    spans = sorted(spans, key=lambda s: s[1] - s[0], reverse=True)
    kept = []
    for s in spans:
        if all(min(s[1], k[1]) - max(s[0], k[0]) < 0 for k in kept):
            kept.append(s)
    kept.sort(key=lambda s: s[0])
    return [doc[s[0]:s[1] + 1].text for s in kept]


def _heuristic_noun_chunks(expression: str) -> List[str]:
    """spaCy-free approximation of the reference chunker
    (visual_search.py:54-112), pinned to hand-derived goldens in
    tests/test_cues.py. Semantics mirrored:

      * coordination ('or'/'and'/commas) SPLITS chunks — each conjunct
        noun heads its own chunk (spaCy 'conj' is not merged,
        get_noun_chunks right-extends only over relcl/prep);
      * prepositional phrases MERGE right into the preceding noun's chunk
        ('corner of the image' stays one chunk — 'prep' right-extension);
      * leading determiners/prepositions/adverbs/copulas/participles are
        outside the chunk ('on the kitchen counter' -> 'kitchen counter' —
        left-extension only covers amod/compound/poss).
    """
    raw = re.findall(r"[A-Za-z0-9'-]+|,", expression)
    # coordination splits top-level segments
    segments: List[List[str]] = [[]]
    for w in raw:
        if w.lower() in _CONJ or w == ",":
            segments.append([])
        else:
            segments[-1].append(w)

    chunks = []
    for seg in segments:
        i = 0
        while i < len(seg) and seg[i].lower() in _STRIPPABLE:
            w = seg[i].lower()
            if w in _AMBIG:
                nxt = seg[i + 1].lower() if i + 1 < len(seg) else None
                if nxt is None or nxt == "of" or nxt not in _STRIPPABLE:
                    break  # noun/modifier use: chunk starts here
            i += 1
        if i >= len(seg):
            continue
        # after the head content word begins, the rest of the segment
        # (internal prep phrases included) belongs to the chunk
        chunks.append(" ".join(seg[i:]))
    return chunks


def extract_noun_chunks(expression: str) -> List[str]:
    if _NLP is not None:
        return _spacy_noun_chunks(expression)
    return _heuristic_noun_chunks(expression)
