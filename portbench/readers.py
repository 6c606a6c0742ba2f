"""The reductions that the per-layer metric files share. Each takes the
reader context ({'layer', 'trace', 'work', 'peaks'}) and returns a
number, or None where the run has nothing to read."""

from __future__ import annotations


def attn_roofline(ctx):
    tr, work, pk = ctx.get("trace"), ctx.get("work"), ctx["peaks"]
    if not tr or work is None or not work.attn or tr["attention_s"] <= 0:
        return None
    bound = sum(max(f / pk["bf16_flops_per_s"], b / pk["hbm_bytes_per_s"])
                for f, b in work.attn)
    return 100.0 * bound / tr["attention_s"]


def mfu(ctx):
    tr, work, pk = ctx.get("trace"), ctx.get("work"), ctx["peaks"]
    if not tr or tr["busy_s"] <= 0 or work is None or work.flops <= 0:
        return None             # no device activity traced: nothing read
    return 100.0 * work.flops / (tr["window_s"] * pk["bf16_flops_per_s"])


def device_idle(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
