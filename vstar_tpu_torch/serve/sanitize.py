"""Input sanitization for the serving surface.

Mirrors app.py:132-137 (bleach.clean + control-pattern stripping); bleach
is optional — the regex path covers the same injection vectors."""

from __future__ import annotations

import re

_TAG_RE = re.compile(r"<[^>]*>")
_CTRL_RE = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f]")
_TEMPLATE_RE = re.compile(r"[\n]{3,}")


def sanitize_text(text: str, max_len: int = 2000) -> str:
    try:  # pragma: no cover - environment dependent
        import bleach
        text = bleach.clean(text)
    except Exception:
        text = _TAG_RE.sub("", text)
    text = _CTRL_RE.sub("", text)
    text = _TEMPLATE_RE.sub("\n\n", text)
    return text.strip()[:max_len]
