"""The work formulas against counts done by hand at tiny sizes."""

import json

import pytest

from portbench import flops
from portbench.run import HERE

CFG = json.load(open(HERE / "tests" / "tiny.json"))
# hidden 64, FFN 128, 2 layers, 4 heads of 16, 2 KV heads, vocab 319


def test_layer_matmuls():
    # q 64x64, k and v 64x32 each, o 64x64, gate/up/down 64x128 x3
    per_token = 2 * (64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128)
    assert flops.layer_matmul_flops(CFG) == per_token


def test_prefill_and_decode_by_hand():
    w = flops.Work()
    flops.decoder(w, CFG, 0, 3, 1)
    per_token = flops.layer_matmul_flops(CFG)
    # causal: keys 1 + 2 + 3 per layer, 4 * heads * head_dim a key
    attn = 2 * 4 * 4 * 16 * (1 + 2 + 3)
    assert w.flops == pytest.approx(2 * 3 * per_token + 2 * 64 * 319
                                    + attn)
    assert len(w.attn) == 2
    f, b = w.attn[0]
    assert f == 4 * 4 * 16 * 6
    # q and o: 3 tokens x 4 heads x 16; k and v: 3 tokens x 2 KV heads
    assert b == 2 * 16 * (2 * 3 * 4 + 2 * 3 * 2)

    w = flops.Work()
    flops.generate(w, CFG, 5, 3)     # prefill 5, then 2 one-token forwards
    keys = (1 + 2 + 3 + 4 + 5) + 6 + 7
    assert w.flops == pytest.approx(
        2 * 7 * per_token + 3 * 2 * 64 * 319 + 2 * 4 * 4 * 16 * keys)
    f_dec, b_dec = w.attn[-1]
    assert f_dec == 4 * 4 * 16 * 7
    assert b_dec == 2 * 16 * (2 * 4 + 2 * 7 * 2)


def test_vit_and_kernel_attention():
    t = CFG["seal"]["owl_vision"]     # 48 / 16 -> 9 patches + CLS, D 32
    w = flops.Work()
    flops.vit(w, t, 1, kernel_min_seq=5)
    S, D, I = 10, 32, 64
    assert w.flops == pytest.approx(2 * 9 * 16 * 16 * 3 * D
                                    + 2 * S * (4 * D * D + 2 * D * I)
                                    + 4 * D * S * S)
    assert w.attn == [(4 * D * S * S, 2 * 4 * S * D)]
    w = flops.Work()
    flops.vit(w, t, 1)               # 10 tokens: plain attention
    assert w.attn == []


def test_calls_work_counts_real_rows_only():
    import torch
    from portbench.drivers import common
    ctx = {"kind": "free_form", "questions": ["a b", "c"],
           "decodes": [(torch.zeros(4, 8), torch.tensor([3, 1, 5, 5]),
                        torch.zeros(4, 8, 64))]}
    one = common.calls_work(CFG, [dict(ctx, questions=["a b"])]).flops
    two = common.calls_work(CFG, [ctx]).flops
    w = flops.Work()
    common._towers(w, CFG, True, None)
    S = common.vqa_length(CFG, common.text.vqa_prompt("c"))
    flops.generate(w, CFG, S, 1)
    assert two == pytest.approx(one + w.flops)
