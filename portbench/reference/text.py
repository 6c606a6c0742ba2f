"""Prompts, token ids and pixels as SEAL builds them, worked out again for
the reference: the stub tokenizer that random-weight runs use (each
whitespace word hashed into the vocabulary; `</s>` 2, `[LOC]` 3, BOS 1),
LLaVA's conversation templates (vicuna v1 for the VQA LLM, llava v1 for
the VSM), the sentinel split of `<image>` / `<object>`, V*Bench's
expand-to-square and CLIP / OWL-ViT resizes (PIL, bicubic), and the
focused re-ask prompt of vstar_bench_eval.py.
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image

from .model import CLIP_MEAN, CLIP_STD

IMAGE, OBJECT = -200, -300
USER_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions.")
HUMAN_SYSTEM = (
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the human's questions.")
FOCUS = "Additional visual information to focus on: "


def token_ids(text: str, vocab: int, bos: bool = True) -> List[int]:
    text = text.replace("</s>", " </s> ").replace("[LOC]", " [LOC] ")
    ids = [1] if bos else []
    for w in text.split():
        ids.append(2 if w == "</s>" else 3 if w == "[LOC]"
                   else 4 + zlib.crc32(w.encode()) % max(1, vocab - 4))
    return ids


def chat(system: str, user: str, answer: Optional[str] = None) -> str:
    """The two-separator template: system, 'USER: ...', 'ASSISTANT:'."""
    out = system + " " + "USER: " + user + " "
    return out + ("ASSISTANT: " + answer + "</s>" if answer
                  else "ASSISTANT:")


def with_sentinels(prompt: str, vocab: int) -> List[int]:
    """BOS, then the chunks' ids with one sentinel at each <image> /
    <object> (the first boundary is the image) and the chunks' own BOS
    dropped."""
    parts: List[str] = []
    for chunk in prompt.split("<image>"):
        parts.extend(chunk.split("<object>"))
    out = [1]
    for i, part in enumerate(parts):
        if i:
            out.append(IMAGE if i == 1 else OBJECT)
        out.extend(token_ids(part, vocab)[1:])
    return out


def vqa_prompt(question: str, answer: Optional[str] = None) -> str:
    return chat(USER_SYSTEM, "<image>\n" + question, answer)


def vsm_prompt(question: str) -> str:
    return chat(HUMAN_SYSTEM, "<im_start><image><im_end>\n" + question)


def focus_question(question: str, names: Sequence[str],
                   boxes: Sequence[Sequence[float]]) -> str:
    msg = FOCUS
    for i, (name, b) in enumerate(zip(names, boxes)):
        msg += "{} <object> at location [{:.3f},{:.3f},{:.3f},{:.3f}]".format(
            name, b[0], b[1], b[2], b[3])
        msg += "; " if i != len(boxes) - 1 else "."
    return msg + "\n" + question


def square(img: Image.Image):
    """Pad to a square with the CLIP mean colour, centred -> (image,
    left, top)."""
    w, h = img.size
    if w == h:
        return img, 0, 0
    side = max(w, h)
    out = Image.new(img.mode, (side, side),
                    tuple(int(x * 255) for x in CLIP_MEAN))
    left, top = (side - w) // 2, (side - h) // 2
    out.paste(img, (left, top))
    return out, left, top


def clip_pixels(img: Image.Image, size: int = 224) -> np.ndarray:
    """Shortest side to `size` (bicubic), centre crop -> uint8."""
    if img.size != (size, size):
        w, h = img.size
        short = min(w, h)
        nw, nh = round(w * size / short), round(h * size / short)
        img = img.resize((nw, nh), Image.BICUBIC)
        left, top = (nw - size) // 2, (nh - size) // 2
        img = img.crop((left, top, left + size, top + size))
    return np.asarray(img.convert("RGB"), np.uint8)


def owl_pixels(img: Image.Image, size: int = 768) -> np.ndarray:
    return np.asarray(img.convert("RGB").resize((size, size), Image.BICUBIC),
                      np.uint8)


def normalize(arr: np.ndarray) -> np.ndarray:
    x = arr.astype(np.float32) / 255.0
    return (x - np.asarray(CLIP_MEAN, np.float32)) \
        / np.asarray(CLIP_STD, np.float32)


def object_crop(image: Image.Image, bbox, size: int = 224,
                scale: float = 1.2) -> np.ndarray:
    """The 1.2x context crop of a found box, resized (vstar_bench_eval)."""
    ow, oh = int(np.ceil(bbox[2])), int(np.ceil(bbox[3]))
    cx, cy = int(bbox[0] + bbox[2] / 2), int(bbox[1] + bbox[3] / 2)
    pw, ph = int(ow * scale), int(oh * scale)
    left, top = max(0, cx - pw // 2), max(0, cy - ph // 2)
    box = (left, top, min(left + pw, image.width),
           min(top + ph, image.height))
    return clip_pixels(image.crop(box).resize((size, size)), size)
