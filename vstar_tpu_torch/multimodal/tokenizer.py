"""Tokenizer sentinel splicing.

Replicates the reference's prompt tokenization, which splits the prompt on
'<image>'/'<object>' and interleaves negative sentinel ids
(LLaVA/llava/mm_utils.py:43-109). The sentinel positions later expand into
vision features (see splicing.py).

Works with any HF tokenizer (LlamaTokenizer for the real checkpoints);
`load_tokenizer` loads a checkpoint's, the port's one call into
`transformers`.
"""

from __future__ import annotations

from typing import List, Sequence

from .constants import (DEFAULT_IMAGE_TOKEN, DEFAULT_OBJECT_TOKEN,
                        IMAGE_TOKEN_INDEX, OBJECT_TOKEN_INDEX)


def _splice(chunks: List[List[int]], seps: List[List[int]],
            bos_id) -> List[int]:
    """Interleave tokenized chunks with separator sentinel lists, handling
    the leading-BOS duplication exactly like the reference."""
    input_ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and bos_id is not None and chunks[0][0] == bos_id:
        offset = 1
        input_ids.append(chunks[0][0])
    # Each separator is repeated (offset+1) times in the reference, then the
    # first `offset` tokens of the following chunk are dropped — net effect:
    # one sentinel, with chunk BOSes stripped.
    seq: List[List[int]] = []
    for i, c in enumerate(chunks):
        seq.append(c)
        if i < len(seps):
            seq.append([s for s in seps[i] for _ in range(offset + 1)])
    for x in seq:
        input_ids.extend(x[offset:])
    return input_ids


def tokenize_with_image(prompt: str, tokenizer) -> List[int]:
    """'<image>' -> IMAGE_TOKEN_INDEX (mm_utils.py:43-62)."""
    chunks = [tokenizer(c).input_ids
              for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    seps = [[IMAGE_TOKEN_INDEX]] * (len(chunks) - 1)
    return _splice(chunks, seps, tokenizer.bos_token_id)


def tokenize_with_image_and_objects(prompt: str, tokenizer) -> List[int]:
    """First boundary -> image sentinel, the rest -> object sentinels
    (mm_utils.py:65-87; assumes '<image>' precedes all '<object>')."""
    parts: List[str] = []
    for chunk in prompt.split(DEFAULT_IMAGE_TOKEN):
        parts.extend(chunk.split(DEFAULT_OBJECT_TOKEN))
    chunks = [tokenizer(c).input_ids for c in parts]
    seps = ([[IMAGE_TOKEN_INDEX]]
            + [[OBJECT_TOKEN_INDEX]] * (len(chunks) - 2))
    return _splice(chunks, seps, tokenizer.bos_token_id)


def find_keyword_stop(output_ids: Sequence[int], generated_text: str,
                      keywords: Sequence[str]) -> bool:
    """KeywordsStoppingCriteria semantics (mm_utils.py:123-148): stop when
    the decoded tail contains any keyword."""
    return any(kw in generated_text for kw in keywords)


def load_tokenizer(model_dir: str, **kwargs):
    """The checkpoint's SentencePiece tokenizer, as vstar_tpu loads it
    (transformers.AutoTokenizer.from_pretrained(model_dir, use_fast=False,
    **kwargs)), from local files only: the port downloads nothing. The
    one place the port reaches for `transformers`, which is imported
    here, when a loader or trainer is given no tokenizer."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"loading the tokenizer of {model_dir} needs the `transformers` "
            "package (and `sentencepiece`); pass an explicit tokenizer "
            "instead") from e
    return AutoTokenizer.from_pretrained(model_dir, use_fast=False,
                                         local_files_only=True, **kwargs)
