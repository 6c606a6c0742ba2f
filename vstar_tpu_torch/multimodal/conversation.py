"""Conversation prompt templates.

Full registry parity with the reference prompt state machine
(reference LLaVA/llava/conversation.py:6-12 separator styles, :29-104
get_prompt, :221-380 template definitions and registry).  The SEAL live
path only uses 'v1' (Vicuna, style TWO) and 'plain' (projector
pretraining), but every reference template name resolves here.

Messages are plain strings (the reference additionally allows
(text, image, mode) tuples on its gradio path; image plumbing is handled
by the serve layer in this framework, so templates stay string-only).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    """Prompt separator styles (conversation.py:6-12)."""
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


VICUNA_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions.")

_V0_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's "
    "questions.")

_MMTAG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user "
    "provides, and assist the user with a variety of tasks using natural "
    "language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>.")

_LLAMA2_SYSTEM = """You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information."""

_LLAVA_LLAMA2_SYSTEM = (
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language.")

_MPT_SYSTEM = """<|im_start|>system
A conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers."""


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    sep: str = "###"
    sep2: Optional[str] = None
    messages: List[List[Optional[str]]] = dataclasses.field(
        default_factory=list)
    sep_style: SeparatorStyle = SeparatorStyle.TWO
    version: str = "Unknown"
    offset: int = 0

    def copy(self) -> "Conversation":
        return Conversation(self.system, self.roles, self.sep, self.sep2,
                            [list(m) for m in self.messages], self.sep_style,
                            self.version, self.offset)

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        """Render the prompt for this separator style (conversation.py:29-104)."""
        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in self.messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret
        if style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in self.messages:
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret
        if style == SeparatorStyle.LLAMA_2:
            ret = ""
            for i, (role, message) in enumerate(self.messages):
                if i == 0 and not message:
                    raise ValueError("first message should not be none")
                if i == 0 and role != self.roles[0]:
                    raise ValueError("first message should come from user")
                if message:
                    if i == 0:
                        message = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" + message
                    if i % 2 == 0:
                        ret += self.sep + f"[INST] {message} [/INST]"
                    else:
                        ret += " " + message + " " + self.sep2
            return ret.lstrip(self.sep)
        if style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += message + seps[i % 2]
            return ret
        raise ValueError(f"Invalid style: {style}")


def conv_vicuna_v0() -> Conversation:
    # The reference seeds v0 with a two-turn few-shot example (offset=2,
    # conversation.py:221-250); reproduced so get_prompt matches byte-for-byte.
    conv = Conversation(system=_V0_SYSTEM, roles=("Human", "Assistant"),
                        sep="###", sep_style=SeparatorStyle.SINGLE,
                        offset=2)
    conv.append_message(
        "Human",
        "What are the key differences between renewable and non-renewable "
        "energy sources?")
    conv.append_message(
        "Assistant",
        "Renewable energy sources are those that can be replenished naturally in a relatively "
        "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
        "Non-renewable energy sources, on the other hand, are finite and will eventually be "
        "depleted, such as coal, oil, and natural gas. Here are some key differences between "
        "renewable and non-renewable energy sources:\n"
        "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
        "energy sources are finite and will eventually run out.\n"
        "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
        "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
        "and other negative effects.\n"
        "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
        "have lower operational costs than non-renewable sources.\n"
        "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
        "locations than non-renewable sources.\n"
        "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
        "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
        "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
        "non-renewable sources are not, and their depletion can lead to economic and social instability.\n")
    return conv


def conv_vicuna_v1() -> Conversation:
    return Conversation(system=VICUNA_SYSTEM, roles=("USER", "ASSISTANT"),
                        sep=" ", sep2="</s>", sep_style=SeparatorStyle.TWO,
                        version="v1")


def conv_llama_2() -> Conversation:
    return Conversation(system=_LLAMA2_SYSTEM, roles=("USER", "ASSISTANT"),
                        sep="<s>", sep2="</s>",
                        sep_style=SeparatorStyle.LLAMA_2, version="llama_v2")


def conv_llava_llama_2() -> Conversation:
    return Conversation(system=_LLAVA_LLAMA2_SYSTEM,
                        roles=("USER", "ASSISTANT"), sep="<s>", sep2="</s>",
                        sep_style=SeparatorStyle.LLAMA_2, version="llama_v2")


def conv_mpt() -> Conversation:
    return Conversation(system=_MPT_SYSTEM,
                        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
                        sep="<|im_end|>", sep_style=SeparatorStyle.MPT,
                        version="mpt")


def conv_llava_plain() -> Conversation:
    return Conversation(system="", roles=("", ""), sep="\n", sep2=None,
                        sep_style=SeparatorStyle.PLAIN)


def conv_llava_v0() -> Conversation:
    return Conversation(system=_V0_SYSTEM, roles=("Human", "Assistant"),
                        sep="###", sep_style=SeparatorStyle.SINGLE)


def conv_llava_v0_mmtag() -> Conversation:
    return Conversation(system=_MMTAG_SYSTEM, roles=("Human", "Assistant"),
                        sep="###", sep_style=SeparatorStyle.SINGLE,
                        version="v0_mmtag")


def conv_llava_v1() -> Conversation:
    # Identical rendering to vicuna_v1 save for the human/user system line
    # (conversation.py:335-345).
    return Conversation(system=_V0_SYSTEM, roles=("USER", "ASSISTANT"),
                        sep=" ", sep2="</s>", sep_style=SeparatorStyle.TWO,
                        version="v1")


def conv_llava_v1_mmtag() -> Conversation:
    return Conversation(system=_MMTAG_SYSTEM, roles=("USER", "ASSISTANT"),
                        sep=" ", sep2="</s>", sep_style=SeparatorStyle.TWO,
                        version="v1_mmtag")


# Registry name -> factory (conversation.py:362-379).  Factories (rather than
# shared instances) so callers can't mutate the template in place — the
# reference requires .copy() discipline instead.
CONV_TEMPLATES = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}
