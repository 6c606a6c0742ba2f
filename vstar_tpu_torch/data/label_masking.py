"""Vicuna-v1 conversation tokenization + instruction label masking.

Mirrors the reference preprocess_v1 (LLaVA/llava/train/train_search.py:
435-522; same function embedded in VisualSearch's llava): rounds split on
'</s>', instruction tokens (up to and including 'ASSISTANT: ') masked to
IGNORE_INDEX, with the reference's "-2" separator-length accounting.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..multimodal.constants import IGNORE_INDEX
from ..multimodal.conversation import conv_vicuna_v1
from ..multimodal.tokenizer import (tokenize_with_image,
                                    tokenize_with_image_and_objects)


def build_conversation_prompt(source: Sequence[Dict]) -> str:
    """source: [{'from': 'human'|'gpt', 'value': str}, ...] -> v1 prompt."""
    conv = conv_vicuna_v1()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    if roles[source[0]["from"]] != conv.roles[0]:
        source = source[1:]
    for j, sentence in enumerate(source):
        role = roles[sentence["from"]]
        assert role == conv.roles[j % 2]
        conv.append_message(role, sentence["value"])
    return conv.get_prompt()


def _tok(text: str, tokenizer, has_image: bool, has_object: bool
         ) -> List[int]:
    if has_image and has_object:
        return tokenize_with_image_and_objects(text, tokenizer)
    if has_image:
        return tokenize_with_image(text, tokenizer)
    return tokenizer(text).input_ids


def preprocess_v1(source: Sequence[Dict], tokenizer,
                  has_image: bool = True, has_object: bool = False
                  ) -> Dict[str, np.ndarray]:
    """One conversation -> (input_ids, labels) with instruction masking.

    Returns numpy int32 arrays (variable length; batching is a separate
    step). Sentinel ids stay negative; their expansion to IGNORE happens in
    the splice layout (build_layout)."""
    conv = conv_vicuna_v1()
    conversation = build_conversation_prompt(source)
    input_ids = np.asarray(_tok(conversation, tokenizer, has_image,
                                has_object), np.int32)
    labels = input_ids.copy()

    sep = conv.sep + conv.roles[1] + ": "   # " ASSISTANT: "
    rounds = conversation.split(conv.sep2)   # split on '</s>'
    cur = 1
    labels[:cur] = IGNORE_INDEX
    for rou in rounds:
        if rou == "":
            break
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        head = parts[0] + sep
        round_len = len(_tok(rou, tokenizer, has_image, has_object))
        instruction_len = len(_tok(head, tokenizer, has_image,
                                   has_object)) - 2
        labels[cur:cur + instruction_len] = IGNORE_INDEX
        cur += round_len
    labels[cur:] = IGNORE_INDEX

    if cur != len(input_ids):
        # tokenization mismatch: ignore the sample (reference warns and
        # zeroes the labels, train_search.py:511-517)
        labels[:] = IGNORE_INDEX
    return {"input_ids": input_ids, "labels": labels}
