"""Checkpoint-key audit for torch state_dict imports (strict mode; port of
vstar_tpu/core/import_audit.py, which imports no JAX: a copy).

The day the real `craigwu/seal_vqa_7b` / `seal_vsm_7b` weights become
reachable, the cheapest insurance against silent mis-imports is an exact
accounting of every checkpoint key: which the importers consumed, which
are intentionally skipped (dead buffers, unused towers), and which are
unknown or missing. Reference schemas: LLaVA/llava/model/builder.py:26-151
and VisualSearch/model/VSM.py:74-140.

Usage:
    report = audit_import(sd, lambda sd: vqa_llm_params_from_torch(sd, cfg))
    report.raise_on_problems()        # strict mode
Committed manifests (vstar_tpu_torch/manifests/*.keys.txt, copies of
the JAX package's, generated by scripts/gen_key_manifests.py from
depth-exact reference models) pin the expected schemas so the audit can
also run against a bare key list.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Iterable, List, Mapping, Set

# Keys present in reference-era checkpoints that this framework
# intentionally does not import:
DEFAULT_SKIP_PATTERNS: List[str] = [
    # rotary tables / position-id buffers (recomputed, not weights;
    # persistent buffers in transformers<=4.31 which saved the originals)
    r".*rotary_emb\.inv_freq$",
    r".*embeddings\.position_ids$",
    # CLIP's unused projection head inside CLIPVisionModel checkpoints
    r".*visual_projection\.weight$|^visual_projection\.weight$",
    # OWL-ViT text tower: the VSM conditions detection on [LOC] hidden
    # states, never on text queries (owlvit.py:28-33 keeps only
    # vision_model/class_head/box_head/layer_norm)
    r"(model\.)?owlvit\.text_model\..*",
    r"(model\.)?owlvit\.text_projection\..*",
    r"(model\.)?owlvit\.logit_scale$",
    # SAM prompt-encoder branches unused by the text-prompt path: the VSM
    # always calls it with points=None, boxes=None, masks=None
    # (VSM.py:322-331), so point/box embeddings and the mask-downscaling
    # conv stack never run; only pe_layer/no_mask_embed are consumed.
    r"(model\.)?prompt_encoder\.mask_downscaling\..*",
    r"(model\.)?prompt_encoder\.point_embeddings\..*",
    r"(model\.)?prompt_encoder\.not_a_point_embed\..*",
    # vestigial LoRA zeros occasionally left in merged exports
    r".*\.lora_(A|B)\.weight$",
]


class RecordingMapping(Mapping):
    """Wraps a state_dict and records every key actually read."""

    def __init__(self, base: Mapping):
        self._base = base
        self.accessed: Set[str] = set()
        self.missing: Set[str] = set()

    def __getitem__(self, k):
        if k not in self._base:
            self.missing.add(k)
            raise KeyError(k)
        self.accessed.add(k)
        return self._base[k]

    def __contains__(self, k):
        return k in self._base

    def __iter__(self):
        return iter(self._base)

    def __len__(self):
        return len(self._base)

    def items(self):
        # Importers iterating items() (strip_prefix) see everything; that
        # alone does not mark keys consumed — only __getitem__ does.
        return self._base.items()


@dataclasses.dataclass
class ImportAudit:
    consumed: List[str]
    skipped: List[str]     # present, unconsumed, matching a skip pattern
    unknown: List[str]     # present, unconsumed, NOT skippable
    missing: List[str]     # importer asked for these; absent
    # the importer raised at the FIRST missing key: `missing` holds only
    # that key and present-key classification is unreliable (everything
    # the importer never reached would look unconsumed). Use the
    # manifest-based audit_key_list for the complete lists.
    aborted: bool = False

    def summary(self) -> str:
        s = (f"consumed {len(self.consumed)}, skipped "
             f"{len(self.skipped)}, unknown {len(self.unknown)}, "
             f"missing {len(self.missing)}")
        if self.aborted:
            s += (" (PARTIAL: importer aborted at the first missing key;"
                  " unknown/skipped suppressed — audit the key list"
                  " against the manifest for full lists)")
        return s

    def raise_on_problems(self) -> None:
        if self.unknown or self.missing:
            msg = [f"checkpoint import audit failed: {self.summary()}"]
            if self.missing:
                msg.append("missing keys (importer needs these): "
                           + ", ".join(sorted(self.missing)[:20]))
            if self.unknown:
                msg.append("unknown keys (present but never consumed): "
                           + ", ".join(sorted(self.unknown)[:20]))
            raise KeyError("\n".join(msg))


def audit_import(sd: Mapping, importer: Callable[[Mapping], object],
                 skip_patterns: Iterable[str] = tuple(DEFAULT_SKIP_PATTERNS)
                 ) -> ImportAudit:
    """Run `importer` over a recording view of `sd` and account every key.
    The importer's return value is discarded; missing keys abort it (and
    are reported) rather than surfacing as a stray KeyError later."""
    rec = RecordingMapping(sd)
    aborted = False
    try:
        importer(rec)
    except KeyError:
        if not rec.missing:
            raise
        aborted = True
    skipped, unknown = [], []
    if not aborted:
        # classification is only meaningful when the importer finished —
        # after an abort, every key it never reached would look
        # unconsumed and flood `unknown` with false positives
        pats = [re.compile(p) for p in skip_patterns]
        for k in sd:
            if k in rec.accessed:
                continue
            (skipped if any(p.fullmatch(k) for p in pats)
             else unknown).append(k)
    return ImportAudit(consumed=sorted(rec.accessed),
                       skipped=sorted(skipped),
                       unknown=sorted(unknown),
                       missing=sorted(rec.missing),
                       aborted=aborted)


def strict_import(sd: Mapping, importer: Callable[[Mapping], object],
                  skip_patterns: Iterable[str] = tuple(
                      DEFAULT_SKIP_PATTERNS)):
    """Import once through a recording view; raise if any present key is
    neither consumed nor skippable-by-design, or if a needed key is
    missing. Returns the importer's result."""
    rec = RecordingMapping(sd)
    try:
        result = importer(rec)
    except KeyError as e:
        raise KeyError(
            f"checkpoint is missing key(s) the importer needs: "
            f"{sorted(rec.missing) or e}") from e
    pats = [re.compile(p) for p in skip_patterns]
    unknown = [k for k in sd if k not in rec.accessed
               and not any(p.fullmatch(k) for p in pats)]
    if unknown:
        raise KeyError(
            f"checkpoint has {len(unknown)} key(s) this importer never "
            f"consumes (schema drift?): {sorted(unknown)[:20]}")
    return result


# ---------------------------------------------------------------------------
# Manifests
# ---------------------------------------------------------------------------

MANIFEST_DIR = os.path.join(os.path.dirname(__file__), "..", "manifests")


def manifest_path(name: str) -> str:
    return os.path.join(MANIFEST_DIR, f"{name}.keys.txt")


def load_manifest(name: str) -> List[str]:
    with open(manifest_path(name)) as f:
        return [ln.strip() for ln in f if ln.strip()
                and not ln.startswith("#")]


def audit_key_list(present_keys: Iterable[str], manifest_name: str,
                   skip_patterns: Iterable[str] = tuple(
                       DEFAULT_SKIP_PATTERNS)) -> ImportAudit:
    """Audit a bare key list (no tensors needed) against a committed
    manifest of keys the importer consumes."""
    expected = set(load_manifest(manifest_name))
    present = set(present_keys)
    pats = [re.compile(p) for p in skip_patterns]
    skipped, unknown = [], []
    for k in present - expected:
        (skipped if any(p.fullmatch(k) for p in pats) else unknown).append(k)
    return ImportAudit(consumed=sorted(expected & present),
                       skipped=sorted(skipped), unknown=sorted(unknown),
                       missing=sorted(expected - present))
