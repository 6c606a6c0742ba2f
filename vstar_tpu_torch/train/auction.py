"""Hungarian matching on the device via the auction algorithm (port of
vstar_tpu/train/auction.py).

Bertsekas' auction, vectorized over the [T, Q] value matrix and batched
over the rows: targets (T, at most ~100) bid for queries (Q = 2304) in
parallel (Jacobi) rounds, each query takes its best bid. One phase from
zero prices, eps = 1e-6 of the row's value range, first-index argmax on
ties, at most `max_iters` rounds and a greedy completion for targets
still unassigned after them: the JAX package's algorithm step for step,
so the two give the same assignment. JAX ran the rounds in a
lax.while_loop; here a Python loop asks the device once per round
whether every target is assigned (the only host read), and `stats`
counts the rounds and their wall time.
"""

from __future__ import annotations

import time

import torch

NEG = -1e15

# calls, rounds and seconds of auction_match since the last reset
stats = {"calls": 0, "rounds": 0, "seconds": 0.0}


def _drop_scatter(x: torch.Tensor, index: torch.Tensor, value) -> torch.Tensor:
    """x.at[index].set(value, mode='drop') along dim 1: indices equal to
    x.shape[1] are dropped."""
    ext = torch.cat([x, x[:, :1]], dim=1)
    ext.scatter_(1, index, value)
    return ext[:, :-1]


def _auction(value: torch.Tensor, valid: torch.Tensor, eps: torch.Tensor,
             max_iters: int) -> torch.Tensor:
    """value [B, T, Q] (maximize), valid [B, T] bool, eps [B] -> owner
    [B, Q] int64 (owning target per query, -1 if none)."""
    B, T, Q = value.shape
    dev = value.device
    value = torch.where(valid[..., None], value, torch.full_like(value, NEG))
    q_ids = torch.arange(Q, device=dev)
    price = torch.zeros((B, Q), dtype=torch.float32, device=dev)
    owner = torch.full((B, Q), -1, dtype=torch.long, device=dev)
    assigned = ~valid           # invalid targets never bid
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    it = 0
    while it < max_iters and not bool(assigned.all()):
        net = value - price[:, None, :]
        net = torch.where(assigned[..., None], neg, net)
        w1, j_star = net.max(dim=2)                         # [B, T]
        w2 = net.scatter(2, j_star[..., None], NEG).amax(dim=2)
        bid = price.gather(1, j_star) + (w1 - w2) + eps[:, None]
        bidding = ~assigned
        onehot = (j_star[..., None] == q_ids) & bidding[..., None]
        bids_mat = torch.where(onehot, bid[..., None], neg)  # [B, T, Q]
        best_bid, winner = bids_mat.max(dim=1)              # [B, Q]
        got = best_bid > NEG / 2
        # evict the previous owners of re-bid queries, then assign
        old = torch.where(got & (owner >= 0), owner, T)
        assigned = _drop_scatter(assigned, old, False)
        owner = torch.where(got, winner, owner)
        price = torch.where(got, best_bid, price)
        assigned = _drop_scatter(assigned, torch.where(got, winner, T), True)
        it += 1
    stats["rounds"] += it
    if not bool(assigned.all()):
        # greedy completion (max_iters hit on adversarial ties): each
        # leftover target takes its best unowned query, in target order
        for t in range(T):
            free = owner < 0
            pick = torch.where(free, value[:, t], neg).argmax(dim=1)
            need = valid[:, t] & ~assigned[:, t]
            rows = torch.nonzero(need).flatten()
            owner[rows, pick[rows]] = t
            assigned[rows, t] = True
    return owner


def auction_match(cost: torch.Tensor, tgt_valid: torch.Tensor,
                  max_iters: int = 3000) -> torch.Tensor:
    """[B, Q, T] costs + [B, T] validity -> matched query per target
    [B, T] int64 (undefined where invalid). Drop-in for
    `hungarian_match`; runs without grad."""
    t0 = time.perf_counter()
    with torch.no_grad():
        B, Q, T = cost.shape
        value = -cost.detach().float().transpose(1, 2)      # [B, T, Q]
        inf = torch.tensor(float("inf"), device=cost.device)
        vmax = torch.where(tgt_valid[..., None], value, -inf).amax(dim=(1, 2))
        vmin = torch.where(tgt_valid[..., None], value, inf).amin(dim=(1, 2))
        rng = torch.where(torch.isfinite(vmax - vmin),
                          torch.clamp(vmax - vmin, min=1e-6),
                          torch.ones_like(vmax))
        owner = _auction(value, tgt_valid.bool(), rng * 1e-6, max_iters)
        safe = torch.where(owner >= 0, owner, T)
        match = torch.zeros((B, T), dtype=torch.long, device=cost.device)
        match = _drop_scatter(match, safe,
                              torch.arange(Q, device=cost.device)
                              .expand(B, Q).contiguous())
    stats["calls"] += 1
    stats["seconds"] += time.perf_counter() - t0
    return match
