"""Token-level constants shared across the system.

Mirrors the reference constants (LLaVA/llava/constants.py:7-15) so that
prompts, sentinels, and label masking behave identically.
"""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
OBJECT_TOKEN_INDEX = -300

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_OBJECT_TOKEN = "<object>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

# VSM special token whose hidden state drives the seg/det heads
# (VisualSearch/train.py:140-147 adds "[LOC]" to the tokenizer).
DEFAULT_LOC_TOKEN = "[LOC]"

# CLIP preprocessing constants (openai/clip-vit-large-patch14 processor).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# OWL-ViT preprocessing constants (google/owlvit-base-patch16 processor).
OWLVIT_MEAN = (0.48145466, 0.4578275, 0.40821073)
OWLVIT_STD = (0.26862954, 0.26130258, 0.27577711)
