"""Typed configuration tree for every model in the framework.

The reference system (penghao-wu/vstar) configures its models through a mix of
argparse, HF config objects, and shell scripts. Here the whole system is
described by one tree of frozen dataclasses with named presets.

Reference parity notes (file:line cites into the reference repository):
  * VQA LLM  = CLIP ViT-L/14 tower + dual projectors + Vicuna-7B decoder
    (LLaVA/llava/model/llava_search_arch.py:10-24).
  * VSM      = linear-projector LLaVA-7B + OWL-ViT B/16 heads + SAM decoder
    (VisualSearch/model/VSM.py:74-140).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LlamaConfig:
    """LLaMA decoder config (Vicuna-7B-v1.x shape by default)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class ViTConfig:
    """CLIP-style pre-LN vision transformer.

    Covers both towers used by the system:
      * CLIP ViT-L/14 @ 224 (VQA tower; reference
        LLaVA/llava/model/multimodal_encoder/clip_encoder.py:7-78)
      * OWL-ViT ViT-B/16 @ 768 (VSM detector tower; reference
        VisualSearch/model/owlvit/owlvit.py:121-148)
    """

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    # 'quick_gelu' matches openai/clip + google/owlvit.
    hidden_act: str = "quick_gelu"
    # Which hidden layer to expose as "features": -2 == penultimate, the
    # LLaVA default (clip_encoder.py:14, select_layer=-2).
    feature_layer: int = -2
    use_class_embedding: bool = True

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_class_embedding else 0)


@dataclass(frozen=True)
class PerceiverConfig:
    """Flamingo-style resampler (reference
    LLaVA/llava/model/multimodal_projector/builder.py:54-68)."""

    dim: int = 1024          # operates at the vision hidden size
    depth: int = 6
    dim_head: int = 96
    heads: int = 16
    num_latents: int = 32
    num_media_embeds: int = 1
    ff_mult: int = 4


@dataclass(frozen=True)
class ProjectorConfig:
    """Vision->LM projector. type in {'linear', 'mlpNx_gelu', 'perceiver'}."""

    type: str = "linear"
    in_dim: int = 1024
    out_dim: int = 4096
    mlp_depth: int = 2
    perceiver: Optional[PerceiverConfig] = None

    @property
    def num_tokens_per_image(self) -> Optional[int]:
        """Output tokens per image; None => same as input token count."""
        if self.type == "perceiver":
            assert self.perceiver is not None
            return self.perceiver.num_latents
        return None


@dataclass(frozen=True)
class OwlHeadConfig:
    """OWL-ViT detection heads (HF OwlViTForObjectDetection shapes).

    class head: dense0 768->512, logit_shift/scale 768->1 (query-conditioned
    cosine logits); box head: 3-layer GELU MLP 768->768->768->4 with grid
    box bias (reference VisualSearch/model/owlvit/owlvit.py:63-100).
    """

    vision_dim: int = 768
    query_dim: int = 512
    num_queries: int = 1


@dataclass(frozen=True)
class SamDecoderConfig:
    """SAM prompt-encoder + mask-decoder config
    (reference VisualSearch/model/VSM.py:92-112)."""

    embed_dim: int = 256
    image_embedding_size: Tuple[int, int] = (48, 48)
    input_image_size: Tuple[int, int] = (768, 768)
    mask_in_chans: int = 16
    num_multimask_outputs: int = 3
    transformer_depth: int = 2
    transformer_mlp_dim: int = 2048
    transformer_num_heads: int = 8
    attention_downsample_rate: int = 2
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


@dataclass(frozen=True)
class VQALLMConfig:
    """The dual-projector search-aware VQA LLM ("seal_vqa_7b").

    <image> expands to 256 linear tokens (long) or 32 perceiver latents
    (short); <object> likewise (reference llava_search_arch.py:95-279).
    """

    llama: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    projector_image: ProjectorConfig = dataclasses.field(
        default_factory=lambda: ProjectorConfig(type="linear"))
    projector_object: ProjectorConfig = dataclasses.field(
        default_factory=lambda: ProjectorConfig(
            type="perceiver", perceiver=PerceiverConfig()))
    max_objects: int = 3          # collator pads to exactly 3 object slots
    context_len: int = 2048

    @property
    def image_tokens_long(self) -> int:
        return self.vision.num_patches

    @property
    def image_tokens_short(self) -> int:
        assert self.projector_object.perceiver is not None
        return self.projector_object.perceiver.num_latents


@dataclass(frozen=True)
class VSMConfig:
    """The visual search model ("seal_vsm_7b"): plain LLaVA-7B with
    [LOC]-driven OWL-ViT det head + SAM seg head (VSM.py:58-160)."""

    llama: LlamaConfig = dataclasses.field(
        default_factory=lambda: LlamaConfig(vocab_size=32003))
    vision: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    owl_vision: ViTConfig = dataclasses.field(
        default_factory=lambda: ViTConfig(
            image_size=768, patch_size=16, hidden_size=768,
            intermediate_size=3072, num_layers=12, num_heads=12,
            feature_layer=-1))
    owl_head: OwlHeadConfig = dataclasses.field(default_factory=OwlHeadConfig)
    sam: SamDecoderConfig = dataclasses.field(default_factory=SamDecoderConfig)
    projector: ProjectorConfig = dataclasses.field(
        default_factory=lambda: ProjectorConfig(type="linear"))
    out_dim: int = 512            # det text-FC output (train.py:80 out_dim)
    seg_dim: int = 256            # seg text-FC output (VSM.py:131-137)
    context_len: int = 512

    @property
    def image_tokens(self) -> int:
        return self.vision.num_patches  # 256 linear tokens


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def vqa_llm_7b() -> VQALLMConfig:
    """Full-size seal_vqa_7b (vocab 32000 + <im_patch>,<im_start>,<im_end>)."""
    return VQALLMConfig(llama=LlamaConfig(vocab_size=32003))


def vsm_7b() -> VSMConfig:
    """Full-size seal_vsm_7b (vocab 32000 + [LOC],<im_start>,<im_end>)."""
    return VSMConfig()


def _llama_13b(vocab: int) -> LlamaConfig:
    return LlamaConfig(vocab_size=vocab, hidden_size=5120,
                       intermediate_size=13824, num_layers=40,
                       num_heads=40, num_kv_heads=40)


def vqa_llm_13b() -> VQALLMConfig:
    """Vicuna-13B-shaped VQA LLM (no public seal checkpoint; the reference
    builder supports any Vicuna size via config.json — so do the importers
    here, see core/hf_config.py)."""
    return VQALLMConfig(
        llama=_llama_13b(32003),
        projector_image=ProjectorConfig(type="linear", out_dim=5120),
        projector_object=ProjectorConfig(
            type="perceiver", out_dim=5120, perceiver=PerceiverConfig()))


def vsm_13b() -> VSMConfig:
    """Vicuna-13B-shaped VSM."""
    return VSMConfig(llama=_llama_13b(32003),
                     projector=ProjectorConfig(type="linear", out_dim=5120))


def _tiny_llama(vocab: int = 320) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=4, head_dim=16,
        max_position_embeddings=2048)


def _tiny_vit(image_size: int = 28, patch: int = 14) -> ViTConfig:
    return ViTConfig(
        image_size=image_size, patch_size=patch, hidden_size=32,
        intermediate_size=64, num_layers=2, num_heads=4)


def vqa_llm_tiny() -> VQALLMConfig:
    """Tiny config for unit tests (CPU-mesh friendly)."""
    vit = _tiny_vit()
    return VQALLMConfig(
        llama=_tiny_llama(),
        vision=vit,
        projector_image=ProjectorConfig(type="linear", in_dim=32, out_dim=64),
        projector_object=ProjectorConfig(
            type="perceiver", in_dim=32, out_dim=64,
            perceiver=PerceiverConfig(dim=32, depth=2, dim_head=8, heads=2,
                                      num_latents=4)),
    )


def vsm_tiny() -> VSMConfig:
    vit = _tiny_vit()
    owl = ViTConfig(image_size=48, patch_size=16, hidden_size=32,
                    intermediate_size=64, num_layers=2, num_heads=4,
                    feature_layer=-1)
    return VSMConfig(
        llama=_tiny_llama(),
        vision=vit,
        owl_vision=owl,
        owl_head=OwlHeadConfig(vision_dim=32, query_dim=24),
        sam=SamDecoderConfig(
            embed_dim=32, image_embedding_size=(3, 3),
            input_image_size=(48, 48), transformer_mlp_dim=64,
            transformer_num_heads=4, iou_head_hidden_dim=32),
        projector=ProjectorConfig(type="linear", in_dim=32, out_dim=64),
        out_dim=24,
        seg_dim=32,
    )
