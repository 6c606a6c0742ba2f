"""Supervised fine-tuning step for the VQA LLM (port of
vstar_tpu/train/sft.py; stage 1 and 2 of the reference's pipeline,
LLaVA/llava/train/train.py and train_search.py).

Loss: next-token CE with IGNORE_INDEX masking over the spliced sequence,
matching LlamaForCausalLM's shift-CE (llava_search_llama.py:94-105). The
CLIP tower is frozen in every reference stage: it runs without gradients
(JAX stops them at its parameters), so no gradient is computed through
it; the projectors and the decoder take theirs through the attention
kernels' backward (K7). As in the port's VSM trainer, only the trainable
leaves get gradients (JAX computes all and zeroes the frozen ones); norms,
clips and updates come out the same. The decoder layers are recomputed in
the backward (remat), as JAX's `remat=True`.

On a tree sharded over a mesh (core/mesh.py; JAX's shard_train_step) each
data x fsdp rank takes its rows of the step's batch (the ranks of a
model group the same rows) and the loss's normaliser, the count of
valid tokens, is the whole batch's (summed over those ranks): a rank's
loss is its share of the one-device loss, never a mean of per-rank
means. On a model axis above 1 the decoder is tensor-parallel, and
where the rules split lm_head's vocabulary the log-softmax runs over
the model group (`next_token_logprobs`). The optimizer updates each
rank's shards.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.config import VQALLMConfig
from ..core.mesh import (ModelSplit, local_leaves, mesh_of,
                         model_local_leaves, unshard, with_local)
from ..core.params import (at, blocks, leaves_with_path, map_with_path,
                           replace_leaves)
from ..models.vqa_llm import clip_bank_features, project_bank, \
    spliced_embeds
from ..multimodal.constants import IGNORE_INDEX
from ..nn.llama import llama_forward, lm_logits
from . import optim
from .accumulate import accumulated_grads
from .master import with_f32_master


class TrainState(NamedTuple):
    params: Dict
    opt_state: Any
    step: int


def make_optimizer(learning_rate: float = 2e-5, warmup_steps: int = 100,
                   total_steps: int = 10000, b1: float = 0.9,
                   b2: float = 0.999, grad_clip: float = 1.0,
                   trainable_mask=None,
                   master_f32: bool = False) -> optim.Transformation:
    """Clip, then AdamW (weight decay 0, as every vstar_tpu caller sets
    it) on a linear warmup / cosine decay schedule (the reference's HF
    defaults for the VQA LLM), on flat parameter dicts.

    trainable_mask: bool tree; AdamW state (and f32 masters) exist only
    for trainable leaves, as optax.masked gives.
    master_f32: f32 master weights for bf16 parameter storage."""
    schedule = optim.warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps,
        max(total_steps, warmup_steps + 1))
    adamw = optim.adamw(schedule, b1=b1, b2=b2)
    if master_f32:
        adamw = with_f32_master(adamw)
    if trainable_mask is not None:
        adamw = optim.masked(adamw, dict(leaves_with_path(trainable_mask)))
    return optim.chain(optim.clip_by_global_norm(grad_clip), adamw)


def sharded_for_loss(params: Dict) -> Tuple[Dict, Optional[ModelSplit]]:
    """A training tree as a loss uses it (core/mesh.unshard: the leaves
    outside the layer stack gathered, except on the model axis the
    towers' matrices the rules split there and lm_head's vocabulary
    where they split it; core/mesh.model_local_leaves), with that
    vocabulary split (None: lm_head whole)."""
    local = model_local_leaves(params, vocab=True)
    return (unshard(params, model_local=local),
            local.get("llama.lm_head"))


def next_token_logprobs(llama: Dict, hidden: torch.Tensor,
                        labels: torch.Tensor,
                        vocab: Optional[ModelSplit] = None):
    """LlamaForCausalLM's shift: the log-probability (f32 [B, S-1]) of
    labels[t + 1] under the logits at t, and where it counts (bool
    [B, S-1], False at IGNORE_INDEX). With a vocabulary split `vocab`
    (sharded_for_loss) `llama`'s lm_head holds this rank's vocabulary
    columns and the log-softmax runs over the model group as XLA
    partitions JAX's: the max, the sum of exponentials and the target's
    shifted logit each summed (the max: maxed) over the group, the
    hidden states' gradient summed by vocab.enter."""
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels,
                       torch.zeros_like(shift_labels)).long()[..., None]
    if vocab is None:
        logits = lm_logits(llama, hidden)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        return logp.gather(-1, safe)[..., 0], valid
    h, = vocab.enter(hidden[:, :-1])
    logits = lm_logits(llama, h)
    shifted = logits - vocab.max(logits.amax(-1, keepdim=True))
    lse = torch.log(vocab.reduce(shifted.exp().sum(-1, keepdim=True)))
    V = logits.shape[-1]
    local = safe - vocab.index * V
    mine = (local >= 0) & (local < V)
    picked = torch.where(mine, shifted.gather(-1, local.clamp(0, V - 1)),
                         torch.zeros((), dtype=shifted.dtype,
                                     device=shifted.device))
    return (vocab.reduce(picked) - lse)[..., 0], valid


def sft_loss(params: Dict, cfg: VQALLMConfig, batch: Dict,
             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """batch (tensors on the parameters' device): image [B,H,W,3],
    objects [B,M,H,W,3], text_ids/feat_idx/is_feat [B,S], lens [B],
    labels [B,S] (IGNORE at prompts/feats/pad), optional kv_valid [B,S].
    On a sharded tree the batch is this rank's rows and the loss its
    share of the whole batch's."""
    mesh = mesh_of(params)
    params, vocab = sharded_for_loss(params)
    with torch.no_grad():
        feats = clip_bank_features(params, cfg, batch["image"],
                                   batch["objects"])
    bank = project_bank(params, cfg, feats, batch["image"].shape[0]).to(
        compute_dtype)
    h = spliced_embeds(params, batch["text_ids"], bank, batch["feat_idx"],
                       batch["is_feat"], compute_dtype)
    B, S = batch["text_ids"].shape
    pos = torch.arange(S, device=h.device)[None].expand(B, S)
    hidden, _ = llama_forward(params["llama"], cfg.llama, h, pos,
                              batch["lens"], kv_valid=batch.get("kv_valid"),
                              remat=True)
    tok_lp, valid = next_token_logprobs(params["llama"], hidden,
                                        batch["labels"], vocab)
    count = valid.sum() if mesh is None else mesh.batch_sum(valid.sum())
    return -(tok_lp * valid).sum() / torch.clamp(count, min=1)


def sft_train_step(state: TrainState, batch: Dict, cfg: VQALLMConfig,
                   optimizer: optim.Transformation,
                   trainable_mask: Optional[Dict] = None,
                   compute_dtype=torch.bfloat16, grad_accum: int = 1
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One SFT step over `batch` (grad_accum micro-batches). Freezing is a
    trainable_mask tree of booleans (None: every float leaf, the tower's
    gradient then zero); the new state shares every frozen leaf with the
    old one. On a sharded tree every rank passes the same whole batch and
    takes its rows of it (core/mesh.Mesh.local_rows); the metrics are
    the whole batch's on every rank."""
    mesh = mesh_of(state.params)
    if mesh is not None:
        batch = mesh.local_rows(batch, grad_accum)
    loss, _, grads = accumulated_grads(
        lambda p, b: sft_loss(p, cfg, b, compute_dtype), state.params,
        batch, grad_accum, trainable=trainable_mask)
    metrics = {"loss": loss if mesh is None else mesh.batch_sum(loss),
               "grad_norm": optim.global_norm(grads, local_leaves(dict(
                   leaves_with_path(state.params)))),
               "step": state.step}
    new_params, new_opt = apply_step(state.params, grads, state.opt_state,
                                     optimizer)
    return TrainState(new_params, new_opt, state.step + 1), metrics


def apply_step(params: Dict, grads: Dict, opt_state, optimizer
               ) -> Tuple[Dict, Any]:
    """The optimizer's update of `params` (a tree, DTensor leaves updated
    through their local shards) by `grads` (path -> tensor, local shards
    on a sharded tree, consumed: emptied, and the optimizer updates in
    the gradients' buffers), one leaf at a time as XLA's fused update
    runs: the clip's norm over the whole tree first, then each leaf's
    gradient through the optimizer's leaf update into its new parameter
    (a large leaf block by block, core/params.blocks), its gradient and
    temporaries dropped before the next leaf. -> (new params, new
    optimizer state, which reuses the old one's tensors)."""
    flat = dict(leaves_with_path(params))
    local = local_leaves(flat)
    leaf, new_opt = optimizer.start(grads, opt_state, local)
    new = {}
    # the largest leaves last: by then the earlier leaves' f32 gradients
    # have made room for the new parameters
    for p in sorted(grads, key=lambda p: grads[p].numel()):
        g, x = grads.pop(p), local[p]
        parts = blocks(x) if g.is_contiguous() else [None]
        if parts != [None]:
            new[p] = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        for index in parts:
            u = leaf(p, at(g, index), index)
            y = optim.apply_updates({p: at(x, index)}, {p: u})[p]
            if index is None:
                new[p] = y
            else:
                at(new[p], index).copy_(y)
            del u, y
        del g
    if mesh_of(params) is not None:
        new = {p: with_local(flat[p], x) for p, x in new.items()}
    return replace_leaves(params, new), new_opt


def init_train_state(params: Dict, optimizer: optim.Transformation
                     ) -> TrainState:
    """Optimizer state on the leaves (on a sharded tree: on this rank's
    shards, so masters and moments are sharded as their leaves)."""
    return TrainState(params, optimizer.init(local_leaves(dict(
        leaves_with_path(params)))), 0)


def make_frozen_vision_mask(params: Dict) -> Dict:
    """Mask freezing the CLIP tower (the reference freezes it during
    SFT)."""
    return map_with_path(lambda path, _: not path.startswith("vision."),
                         params)
