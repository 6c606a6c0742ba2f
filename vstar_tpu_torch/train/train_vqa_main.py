"""VQA-LLM training command lines (port of vstar_tpu/train/train_vqa_main.py),
on one device or a mesh of them.

Stage 1, projector alignment (LLaVA/scripts/pretrain.sh + train.py):
  python -m vstar_tpu_torch.train.train_vqa_main pretrain \\
      --data_path blip_laion_cc_sbu_558k.json --image_folder images \\
      --projector linear|perceiver
  Trains only the chosen projector (lr 2e-3 linear / 2e-4 perceiver) over
  a frozen bf16 model and writes just the adapter (the mm_projector.bin
  equivalent; llava_trainer.py:150-175). The projector keeps f32 storage.

Stage 2, search-instruction finetune (finetune.sh + train_search.py):
  python -m vstar_tpu_torch.train.train_vqa_main finetune \\
      --model_path <seal_vqa HF dir> --data_path <6-json dir> \\
      --image_folder <images>
  Full-model SFT with the vision tower frozen, bf16 with f32 masters,
  lr 2e-5. At 7B that is ~102 GB of static state, more than one 80 GB
  card: on one device the memory check refuses it before the checkpoint
  is read. Its plan fits two cards; its step, which also holds f32
  accumulation buffers and a micro-batch's gradients, needs four:
    torchrun --nproc-per-node 4 -m vstar_tpu_torch.train.train_vqa_main \
        finetune --model_path <dir> ... --mesh 1x4x1
  or with the decoder tensor-parallel over the model axis (--mesh 1x1x4,
  1x2x2).

Under torchrun every rank builds or loads the whole model on its card
(cuda:LOCAL_RANK), shards it over the mesh (core/mesh.py; default 1xNx1)
and drops the rest; every rank reads the same batches (the same
(data_seed, epoch) permutation) and each data x fsdp rank trains on its
rows of each (the ranks of a model group on the same rows), a
checkpoint is one checkpoint of the global state that every rank writes
its pieces of, from which a run resumes on any mesh or on one device
(train_vsm_main.load_state), and rank 0 alone writes the logs and the
exported parameters. Both stages build on the card unless main is
given another device; the tokenizer is the checkpoint's
(multimodal/tokenizer.load_tokenizer) unless one is given.
"""

from __future__ import annotations

import argparse
import json
import os
import random

import torch

from ..core.checkpoint import save_params
from ..core.memory import (check_memory, device_memory_gb,
                           plan_train_memory, step_memory)
from ..core.mesh import (full_tree, is_main_process, rank_device,
                         resolve_mesh, shard_params)
from ..core.params import leaves_with_path, map_with_path
from ..data.prefetch import prefetch_map
from ..data.vsm_collate import batch_to_torch
from ..utils.metrics import AverageMeter, StepTimer
from .sft import (TrainState, init_train_state, make_optimizer,
                  sft_train_step)
from .train_vsm_main import (barrier, check_rows, load_state, log_memory,
                             mesh_dims, save_state, train_mesh)


def _common(p):
    p.add_argument("--data_path", required=True)
    p.add_argument("--image_folder", required=True)
    p.add_argument("--output_dir", default="./runs/vqa")
    p.add_argument("--num_train_epochs", default=1, type=int)
    p.add_argument("--per_device_batch_size", default=4, type=int)
    p.add_argument("--seq_bucket", default=2048, type=int)
    p.add_argument("--log_every", default=50, type=int)
    p.add_argument("--mesh", default=None,
                   help="DxFxM mesh over the torchrun ranks (default 1xNx1;"
                        " 1x1x1 without torchrun)")
    p.add_argument("--param_dtype", choices=["bf16", "f32"], default="bf16",
                   help="parameter storage dtype; bf16 + f32 masters in the"
                   " optimizer is the DeepSpeed-bf16-mode equivalent")
    p.add_argument("--hbm_gb", default=None, type=float,
                   help="device memory for the startup memory check "
                        "(default: the card's)")
    p.add_argument("--data_workers", default=2, type=int,
                   help="threads fetching+collating batches ahead of the "
                        "device (DataLoader num_workers equivalent)")
    p.add_argument("--prefetch_depth", default=4, type=int)
    p.add_argument("--no_shuffle", dest="shuffle", action="store_false",
                   default=True,
                   help="disable the per-epoch (data_seed, epoch)-seeded "
                        "row shuffle (HF Trainer shuffles by default)")
    p.add_argument("--data_seed", default=0, type=int)
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--save_steps", default=500, type=int,
                   help="rolling 'latest' TrainState checkpoint every N "
                        "steps (0 disables); a resume loses <= N steps")


def parse_args(argv=None):
    p = argparse.ArgumentParser("vstar_tpu_torch VQA-LLM training")
    sub = p.add_subparsers(dest="stage", required=True)
    pre = sub.add_parser("pretrain")
    _common(pre)
    pre.add_argument("--projector", choices=["linear", "perceiver"],
                     default="linear")
    pre.add_argument("--learning_rate", default=None, type=float)
    fin = sub.add_parser("finetune")
    _common(fin)
    fin.add_argument("--model_path", required=True)
    fin.add_argument("--learning_rate", default=2e-5, type=float)
    return p.parse_args(argv)


def projector_only_mask(params, which: str):
    key = "proj_image." if which == "linear" else "proj_object."
    return map_with_path(lambda path, _: path.startswith(key), params)


def frozen_vision_mask(params):
    return map_with_path(lambda path, _: not path.startswith("vision."),
                         params)


def check_train_memory(args, params, trainable_mask, device, mesh=None):
    """Print the per-device plan on `mesh` (None: one device) and return
    it; MemoryError if it cannot fit (--hbm_gb, else the card's memory;
    the CPU has no budget). `params` may be on the meta device."""
    hbm_gb = getattr(args, "hbm_gb", None)
    plan = plan_train_memory(params, mesh, trainable_mask=trainable_mask,
                             master_f32=args.param_dtype == "bf16")
    check_memory(plan, hbm_gb=hbm_gb if hbm_gb is not None
                 else device_memory_gb(device),
                 step=step_memory(params, mesh, trainable_mask),
                 what=f"{args.stage} (one device)" if mesh is None
                 else f"{args.stage} (mesh {mesh})")
    return plan


def run_training(args, cfg, params, dataset, collate_fn, tokenizer,
                 trainable_mask, lr):
    """The whole training procedure after model construction, where the
    parameters live: the mesh (--mesh; a sharded tree keeps its own) and
    the memory check, the optimizer, auto-resume from the rolling 'latest'
    checkpoint, prefetched epochs of the shuffled rows (the same
    (data_seed, epoch) streams as vstar_tpu's one-host run, whole on
    every rank, each data x fsdp rank training on its rows of a step),
    metrics.jsonl from rank 0. Returns the final TrainState."""
    device = next(x.device for _, x in leaves_with_path(params))
    mesh, params = train_mesh(args, params)
    plan = check_train_memory(args, params, trainable_mask, device, mesh)
    bs = args.per_device_batch_size
    check_rows(mesh, bs)
    n_steps_epoch = len(dataset) // bs
    total = max(n_steps_epoch, 1) * args.num_train_epochs
    opt = make_optimizer(lr, warmup_steps=min(100, total // 10),
                         total_steps=total, trainable_mask=trainable_mask,
                         master_f32=args.param_dtype == "bf16")
    state = init_train_state(params, opt)
    del params
    log_memory(f"{args.stage} state", plan, device)
    main_rank = is_main_process()
    loss_m = AverageMeter("loss", ":.4f")
    timer = StepTimer()
    os.makedirs(args.output_dir, exist_ok=True)
    shuffle = getattr(args, "shuffle", True)
    data_seed = getattr(args, "data_seed", 0)

    def _load_batch(idxs):
        return collate_fn([dataset[j] for j in idxs], tokenizer)

    def epoch_batches(epoch):
        # the row permutation is a function of (data_seed, epoch) only, so
        # a resumed run rebuilds epoch E's stream and skips by index; every
        # rank builds the same one (an unequal tail is dropped)
        idx = list(range(len(dataset)))
        if shuffle:
            random.Random(hash((data_seed, epoch))).shuffle(idx)
        return [tuple(idx[a * bs:(a + 1) * bs])
                for a in range(n_steps_epoch)]

    latest_dir = os.path.join(args.output_dir, "ckpt_latest")
    save_steps = getattr(args, "save_steps", 0)
    start_epoch = start_step = 0
    meta_path = os.path.join(latest_dir, "meta.json")
    if getattr(args, "auto_resume", False) and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        state = load_state(TrainState, os.path.join(latest_dir, "state"),
                           state, device, mesh)
        start_epoch, start_step = meta["epoch"], meta["step"] + 1
        if start_step >= n_steps_epoch:
            start_epoch, start_step = start_epoch + 1, 0
        if main_rank:
            print(f"[resume] from epoch {meta['epoch']} step {meta['step']}")

    def _save_latest(epoch, step_i):
        os.makedirs(latest_dir, exist_ok=True)
        save_state(state, os.path.join(latest_dir, "state"), mesh)
        barrier(mesh)
        if main_rank:
            with open(meta_path, "w") as f:
                json.dump({"epoch": epoch, "step": step_i,
                           "mesh": mesh_dims(mesh)}, f)

    metrics_path = os.path.join(args.output_dir, "metrics.jsonl")
    with open(metrics_path if main_rank else os.devnull, "a") as log:
        for epoch in range(start_epoch, args.num_train_epochs):
            epoch_start = start_step if epoch == start_epoch else 0
            # ordered parallel fetch + collate: image decode releases the
            # GIL, so worker threads overlap the device step
            loader = prefetch_map(_load_batch,
                                  epoch_batches(epoch)[epoch_start:],
                                  workers=args.data_workers,
                                  depth=args.prefetch_depth)
            for step_i, host in enumerate(loader, start=epoch_start):
                batch = batch_to_torch(host, device)
                timer.data_loaded()
                state, m = sft_train_step(state, batch, cfg, opt,
                                          trainable_mask)
                timer.step_done()
                loss_m.update(float(m["loss"]))
                if epoch == start_epoch and step_i == epoch_start:
                    log_memory(f"{args.stage} first step", plan, device)
                i = epoch * n_steps_epoch + step_i
                if save_steps and (step_i + 1) % save_steps == 0 \
                        and step_i + 1 < n_steps_epoch:
                    _save_latest(epoch, step_i)
                if i % args.log_every == 0 and main_rank:
                    print(f"epoch {epoch} step {i} {loss_m} "
                          f"({timer.batch_time.avg:.2f}s/it)", flush=True)
                    log.write(json.dumps({"epoch": epoch, "step": i,
                                          "loss": loss_m.avg}) + "\n")
                    log.flush()
            if save_steps:
                # epoch-end save so a crash early next epoch never replays
                # this epoch's tail
                _save_latest(epoch, n_steps_epoch - 1)
    barrier(mesh)
    return state


def save_trained(tree, path: str) -> None:
    """The trained parameters (whole, gathered leaf by leaf on a sharded
    tree), written by rank 0."""
    tree = full_tree(tree)
    if is_main_process():
        save_params(tree, path)


def main(argv=None, tokenizer=None, device="cuda"):
    """Both stages from the command line; returns the final TrainState.
    `tokenizer` None loads the checkpoint's (pretrain: vicuna-7b-v1.5's,
    as vstar_tpu does)."""
    from ..core.config import vqa_llm_7b
    from ..multimodal.tokenizer import load_tokenizer
    args = parse_args(argv)
    device = rank_device(device)
    mesh = resolve_mesh(args.mesh, device)
    param_dtype = torch.bfloat16 if args.param_dtype == "bf16" \
        else torch.float32

    if args.stage == "pretrain":
        from ..data.pretrain_dataset import (PretrainCaptionDataset,
                                             collate_pretrain)
        from ..models.vqa_llm import init_vqa_llm_params
        cfg = vqa_llm_7b()
        key = "proj_image" if args.projector == "linear" else "proj_object"

        def build(dev):
            params = init_vqa_llm_params(0, cfg, device=dev,
                                         dtype=param_dtype)
            # the trained projector keeps f32 storage (small), so the
            # adapter is the exact accumulation; the frozen rest stays
            # in param_dtype
            params[key] = map_with_path(lambda _, x: x.float(), params[key])
            return params

        shapes = build("meta")
        mask = projector_only_mask(shapes, args.projector)
        check_train_memory(args, shapes, mask, device, mesh)
        if tokenizer is None:
            tokenizer = load_tokenizer("lmsys/vicuna-7b-v1.5")
        params = build(device)
        if mesh is not None:
            params = shard_params(params, mesh)
        lr = args.learning_rate or (2e-3 if args.projector == "linear"
                                    else 2e-4)
        ds = PretrainCaptionDataset(args.data_path, args.image_folder,
                                    image_size=cfg.vision.image_size)

        def collate(instances, tok):
            return collate_pretrain(instances, tok,
                                    n_long=cfg.image_tokens_long,
                                    n_short=cfg.image_tokens_short,
                                    image_long=args.projector == "linear",
                                    seq_bucket=args.seq_bucket)

        state = run_training(args, cfg, params, ds, collate, tokenizer,
                             mask, lr)
        # adapter-only export (mm_projector.bin equivalent)
        save_trained(state.params[key],
                     os.path.join(args.output_dir, f"{key}_adapter"))
    else:
        from ..core.checkpoint import load_torch_dir
        from ..core.hf_config import vqa_llm_config_for
        from ..data.vqa_sft_dataset import (SearchInstructionDataset,
                                            collate_vqa_sft)
        from ..models.vqa_llm import (init_vqa_llm_params,
                                      vqa_llm_params_from_torch)
        cfg = vqa_llm_config_for(args.model_path)
        # plan from shapes alone: a run that cannot fit is refused before
        # the checkpoint is read
        shapes = init_vqa_llm_params(0, cfg, device="meta",
                                     dtype=param_dtype)
        check_train_memory(args, shapes, frozen_vision_mask(shapes), device,
                           mesh)
        if tokenizer is None:
            tokenizer = load_tokenizer(args.model_path)
        params = vqa_llm_params_from_torch(
            load_torch_dir(args.model_path, device), cfg, dtype=param_dtype)
        if mesh is not None:
            params = shard_params(params, mesh)
        ds = SearchInstructionDataset(args.data_path, args.image_folder,
                                      image_size=cfg.vision.image_size)

        def collate(instances, tok):
            return collate_vqa_sft(instances, tok,
                                   n_long=cfg.image_tokens_long,
                                   n_short=cfg.image_tokens_short,
                                   seq_bucket=args.seq_bucket)

        state = run_training(args, cfg, params, ds, collate, tokenizer,
                             frozen_vision_mask(params), args.learning_rate)
        save_trained(state.params, os.path.join(args.output_dir, "params"))
    return state


if __name__ == "__main__":
    main()
