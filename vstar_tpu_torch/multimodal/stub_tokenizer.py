"""Deterministic stub tokenizer for checkpoint-free runs.

Every end-to-end benchmark (bench.py, coresident/serving benches) and the
serving CLIs' `--random-init` mode drive the real engines with randomly
initialized weights; a real SentencePiece tokenizer lives in the
checkpoint directory, which those runs don't have. This stub hashes each
whitespace word to a stable id in the 7B vocab range and round-trips the
special tokens the stack keys on (`</s>` -> eos 2, `[LOC]` -> 3, bos 1),
so prompt construction, keyword stopping, [LOC] gathering and decode all
exercise their real paths. Output text is `t<id>` words — meaningless by
design (reference tokenizers come from AutoTokenizer,
the reference's vstar_bench_eval.py:40-47).
"""

from __future__ import annotations

import zlib


class StubTokenizer:
    bos_token_id = 1
    eos_token_id = 2

    def __init__(self, vocab_size: int = 31004):
        # default keeps ids identical to the historical bench scripts
        # (4 + crc % 31000); pass the model's vocab for tiny configs
        self._mod = max(1, vocab_size - 4)

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text, add_special_tokens=True):
        text = text.replace("</s>", " </s> ").replace("[LOC]", " [LOC] ")
        ids = [1] if add_special_tokens else []
        for w in text.split():
            ids.append(2 if w == "</s>" else 3 if w == "[LOC]"
                       else 4 + zlib.crc32(w.encode()) % self._mod)
        return self._Out(ids)

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{i}" for i in ids if i > 3)
