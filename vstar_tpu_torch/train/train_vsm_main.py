"""VSM training procedure (port of vstar_tpu/train/train_vsm_main.py, the
counterpart of VisualSearch/train.py), on one device or a mesh of them.

`run_vsm_training` is the whole procedure after model construction:
the mesh and the memory plan, optimizer with the trainable-set mask,
auto-resume (the rolling 'latest' checkpoint first, then the best one),
prefetched epochs of the hybrid dataset, validation-gated checkpoints
(train.py:389-411). It runs where the parameters live; batches move
there. Under torchrun, `--mesh DxFxM` (default 1xNx1 over N ranks, as in
JAX) shards the parameters and the optimizer state over a mesh
(core/mesh.py) after the per-device plan (core/memory.py) has been
checked against the card's memory; every rank reads the same batches
and each data x fsdp rank trains on its rows of each (the ranks of a
model group on the same rows, the decoder tensor-parallel over them for
M > 1), a checkpoint is one checkpoint of the global state that every
rank writes its own pieces of (core/checkpoint.py), and rank 0 alone
writes the logs. A run resumes from a checkpoint written on any mesh or
on one device, onto its own mesh (or one device), as vstar_tpu restores
its Orbax checkpoint onto `like=tuple(state)`: `--auto_resume` after a
change of --mesh or of the card count continues the same run, and
export_main reads ckpt_model/state in one process. `main` builds the model from an HF
checkpoint directory (--version) on the card (each rank's,
cuda:LOCAL_RANK), with LoRA. TensorBoard scalars are left out;
metrics.jsonl keeps them.

    python -m vstar_tpu_torch.train.train_vsm_main --version <seal_vsm dir> \
        --dataset_dir ./dataset --exp_name vsm
    torchrun --nproc-per-node 4 -m vstar_tpu_torch.train.train_vsm_main \
        --version <seal_vsm dir> --dataset_dir ./dataset --mesh 1x4x1
    torchrun --nproc-per-node 4 -m vstar_tpu_torch.train.train_vsm_main \
        --version <seal_vsm dir> --dataset_dir ./dataset --mesh 1x2x2
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from torch.distributed.tensor import DTensor

from ..core.checkpoint import load_params, save_params
from ..core.memory import (check_memory, device_memory_gb,
                           plan_train_memory, step_memory)
from ..core.mesh import (is_main_process, mesh_of, rank_device,
                         resolve_mesh, shard_params, with_local)
from ..core.params import leaves_with_path
from ..data.prefetch import prefetch
from ..data.vsm_collate import batch_to_torch, collate_vsm_rows
from ..utils.metrics import AverageMeter, ProgressMeter, StepTimer
from .lora import vsm_trainable_mask
from .vsm_train import (VSMLossWeights, VSMTrainState, init_train_state,
                        make_vsm_optimizer, vsm_train_step, vsm_val_forward)


def parse_args(argv=None):
    p = argparse.ArgumentParser("vstar_tpu_torch VSM training")
    p.add_argument("--version", default="craigwu/seal_vsm_7b")
    p.add_argument("--dataset_dir", default="./dataset")
    p.add_argument("--log_base_dir", default="./runs")
    p.add_argument("--exp_name", default="vsm")
    p.add_argument("--epochs", default=40, type=int)
    p.add_argument("--steps_per_epoch", default=2500, type=int)
    p.add_argument("--batch_size", default=4, type=int,
                   help="conversation rows per device per step")
    p.add_argument("--grad_accumulation_steps", default=2, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--ce_loss_weight", default=1.0, type=float)
    p.add_argument("--dice_loss_weight", default=0.5, type=float)
    p.add_argument("--bce_loss_weight", default=2.0, type=float)
    p.add_argument("--det_loss_weight", default=0.1, type=float)
    p.add_argument("--lora_r", default=8, type=int)
    p.add_argument("--lora_alpha", default=16, type=int)
    p.add_argument("--warmup_steps", default=100, type=int)
    p.add_argument("--seq_bucket", default=512, type=int)
    p.add_argument("--prefetch_depth", default=2, type=int,
                   help="batches decoded+collated ahead of the device "
                        "(DataLoader workers/prefetch equivalent)")
    p.add_argument("--mask_res", default=768, type=int,
                   help="fixed mask-loss resolution (gt resized on host, "
                        "pred upsampled)")
    p.add_argument("--mesh", default=None,
                   help="DxFxM mesh over the torchrun ranks (default 1xNx1;"
                        " 1x1x1 without torchrun)")
    p.add_argument("--param_dtype", choices=["bf16", "f32"], default="bf16",
                   help="parameter storage dtype; bf16 + f32 masters in the"
                   " optimizer is the DeepSpeed-bf16-mode equivalent")
    p.add_argument("--hbm_gb", default=None, type=float,
                   help="device memory for the startup memory check "
                        "(default: the card's)")
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--save_steps", default=500, type=int,
                   help="rolling 'latest' TrainState checkpoint every N "
                        "steps (0 disables)")
    p.add_argument("--no_eval", action="store_true", default=False)
    p.add_argument("--dataset", default="general_segdet||refer_seg||"
                   "mixed_grounding||vqa")
    p.add_argument("--sample_rates", default="15,4,4,15")
    return p.parse_args(argv)


def train_mesh(args, params):
    """--mesh for a trainer whose parameters were built on this rank's
    device: (mesh or None, the parameters sharded over it). A tree that
    is already sharded keeps its mesh; --mesh must then name it."""
    mesh = mesh_of(params)
    if mesh is not None:
        if args.mesh and tuple(int(x) for x in args.mesh.lower().split(
                "x")) != mesh.dims:
            raise ValueError(f"--mesh {args.mesh}: the parameters are "
                             f"sharded over {mesh}")
        return mesh, params
    device = next(x.device for _, x in leaves_with_path(params))
    mesh = resolve_mesh(args.mesh, device)
    return mesh, params if mesh is None else shard_params(params, mesh)


def check_rows(mesh, rows: int, micro: int = 1) -> None:
    """A step's rows must split into micro-batches over the data x fsdp
    ranks (the ranks of a model group take the same rows)."""
    if mesh is not None and rows % (micro * mesh.row_ranks):
        raise ValueError(f"{rows} rows a step in {micro} micro-batches do "
                         f"not split over the {mesh.row_ranks} data x fsdp "
                         f"ranks of {mesh}")


def mesh_dims(mesh):
    return None if mesh is None else list(mesh.dims)


def global_state(state) -> tuple:
    """tuple(state) with each optimizer-state tensor that belongs to a
    sharded parameter (the moments and masters, kept on this rank's
    shards under the parameter's path) as a DTensor placed as that
    parameter: the state as global tensors, whatever the mesh."""
    params = dict(leaves_with_path(state.params))

    def walk(node):
        if isinstance(node, dict):
            return {k: with_local(params[k], v)
                    if isinstance(v, torch.Tensor)
                    and isinstance(params.get(k), DTensor) else walk(v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node
    return state.params, walk(state.opt_state), state.step


def _local_state(node):
    """The optimizer state's DTensors back to this rank's shards."""
    if isinstance(node, dict):
        return {k: _local_state(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_local_state(v) for v in node)
    return node.to_local() if isinstance(node, DTensor) else node


def save_state(state, path: str, mesh) -> None:
    """A TrainState as one checkpoint of global tensors (every rank of a
    mesh writes its pieces; on one device one file)."""
    save_params(tuple(state) if mesh is None else global_state(state),
                path)


def load_state(cls, path: str, state, device, mesh):
    """The TrainState `save_state` wrote, on any mesh or on one device
    (the meta's "mesh" is information only), onto this run's layout:
    `state`'s placements on a mesh (read into its buffers, so that the
    resumed run holds one state), whole tensors on `device` without
    one."""
    if mesh is None:
        return cls(*load_params(path, tuple(state)))
    params, opt_state, step = load_params(path, global_state(state),
                                          device, into=True)
    return cls(params, _local_state(opt_state), step)


def log_memory(what: str, plan, device) -> None:
    """The plan's bytes beside what this rank has allocated on its card."""
    if torch.device(device).type != "cuda":
        return
    gb = 1024 ** 3
    print(f"[memory] {what}: planned {plan.total_bytes / gb:.2f} GB static "
          f"state per device; allocated "
          f"{torch.cuda.memory_allocated(device) / gb:.2f} GB, peak "
          f"{torch.cuda.max_memory_allocated(device) / gb:.2f} GB on "
          f"{device}", flush=True)


def build_datasets(args, tokenizer, clip_size: int = 224,
                   owl_size: int = 768):
    from ..data.vsm_datasets import (HybridDataset, MixedGroundingDataset,
                                     ReferSegDataset, SegDetDataset,
                                     VQADataset)
    names = args.dataset.split("||")
    rates = [float(r) for r in args.sample_rates.split(",")]
    children = []
    kept_rates = []
    ctor = {"general_segdet": SegDetDataset, "refer_seg": ReferSegDataset,
            "mixed_grounding": MixedGroundingDataset, "vqa": VQADataset}
    for i, (name, rate) in enumerate(zip(names, rates)):
        try:
            children.append(ctor[name](args.dataset_dir,
                                       clip_size=clip_size,
                                       owl_size=owl_size, seed=i))
            kept_rates.append(rate)
        except FileNotFoundError as e:
            print(f"[data] skipping {name}: {e}")
    if not children:
        raise FileNotFoundError("no datasets available under "
                                f"{args.dataset_dir}")
    return HybridDataset(children, kept_rates,
                         samples_per_epoch=args.steps_per_epoch
                         * args.batch_size * args.grad_accumulation_steps,
                         seed=len(names))


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _write_json(obj, path: str, mode: str = "w"):
    with open(path, mode) as f:
        f.write(json.dumps(obj) + ("\n" if mode == "a" else ""))


def run_vsm_training(args, cfg, params, tokenizer, loc_token_id):
    """The whole VSM training procedure after model construction; returns
    the final VSMTrainState."""
    log_dir = os.path.join(args.log_base_dir, args.exp_name)
    os.makedirs(log_dir, exist_ok=True)
    device = next(x.device for _, x in leaves_with_path(params))
    mask = vsm_trainable_mask(params)
    hbm_gb = getattr(args, "hbm_gb", None)
    mesh, params = train_mesh(args, params)
    check_rows(mesh, args.batch_size * args.grad_accumulation_steps,
               args.grad_accumulation_steps)
    plan = plan_train_memory(params, mesh, trainable_mask=mask,
                             master_f32=args.param_dtype == "bf16")
    check_memory(plan, hbm_gb=hbm_gb if hbm_gb is not None
                 else device_memory_gb(device),
                 step=step_memory(params, mesh, mask,
                                  args.grad_accumulation_steps),
                 what="VSM train (one device)" if mesh is None
                 else f"VSM train (mesh {mesh})")
    total_steps = args.epochs * args.steps_per_epoch
    opt = make_vsm_optimizer(args.lr, args.warmup_steps, total_steps,
                             trainable_mask=mask,
                             master_f32=args.param_dtype == "bf16")
    state = init_train_state(params, opt)
    log_memory("VSM train state", plan, device)
    main_rank = is_main_process()

    ckpt_dir = os.path.join(log_dir, "ckpt_model")
    latest_dir = os.path.join(log_dir, "ckpt_latest")
    start_epoch = 0
    start_step = 0
    resumed_best = None
    if args.auto_resume:
        # prefer the rolling step-granular 'latest' over the epoch-gated
        # best checkpoint: a crash mid-epoch loses <= save_steps steps
        if os.path.exists(os.path.join(latest_dir, "meta.json")):
            meta = _read_json(os.path.join(latest_dir, "meta.json"))
            state = load_state(VSMTrainState,
                               os.path.join(latest_dir, "state"), state,
                               device, mesh)
            start_epoch = meta["epoch"]
            start_step = meta["step"] + 1
            if start_step >= args.steps_per_epoch:
                start_epoch, start_step = start_epoch + 1, 0
            resumed_best = meta.get("best_det_acc")
            if main_rank:
                print(f"[resume] from epoch {meta['epoch']} "
                      f"step {meta['step']} (latest)")
        elif os.path.exists(os.path.join(ckpt_dir, "meta.json")):
            meta = _read_json(os.path.join(ckpt_dir, "meta.json"))
            state = load_state(VSMTrainState,
                               os.path.join(ckpt_dir, "state"), state,
                               device, mesh)
            start_epoch = meta["epoch"] + 1
            resumed_best = meta.get("best_det_acc", meta.get("det_acc"))
            if main_rank:
                print(f"[resume] from epoch {meta['epoch']}")

    weights = VSMLossWeights(ce=args.ce_loss_weight,
                             dice=args.dice_loss_weight,
                             bce=args.bce_loss_weight,
                             det=args.det_loss_weight)
    hybrid = build_datasets(args, tokenizer,
                            clip_size=cfg.vision.image_size,
                            owl_size=cfg.owl_vision.image_size)
    meters = {k: AverageMeter(k, ":.4f") for k in
              ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
               "detection_loss")}
    timer = StepTimer()
    metrics_log = os.path.join(log_dir, "metrics.jsonl")

    best_det_acc = -1.0 if resumed_best is None else resumed_best
    for epoch in range(start_epoch, args.epochs):
        epoch_start_step = start_step if epoch == start_epoch else 0
        gen = hybrid.batches(args.batch_size * args.grad_accumulation_steps,
                             skip_batches=epoch_start_step, epoch=epoch)

        def _produce(g=gen):
            # sampling is seeded and stateful, so it stays serial; the
            # whole decode+collate pipeline runs off the step thread
            for rows in g:
                yield collate_vsm_rows(
                    rows, tokenizer, loc_token_id,
                    n_image_tokens=cfg.image_tokens,
                    seq_bucket=args.seq_bucket, mask_res=args.mask_res)

        loader = prefetch(_produce(), depth=args.prefetch_depth)
        progress = ProgressMeter(args.steps_per_epoch, list(meters.values()),
                                 prefix=f"epoch {epoch} ")
        try:
            for step_i in range(epoch_start_step, args.steps_per_epoch):
                batch = batch_to_torch(next(loader), device)
                timer.data_loaded()
                state, m = vsm_train_step(
                    state, batch, cfg, opt, mask, weights,
                    grad_accum=args.grad_accumulation_steps)
                timer.step_done()
                for k in meters:
                    meters[k].update(float(m[k]))
                if args.save_steps and (step_i + 1) % args.save_steps == 0 \
                        and step_i + 1 < args.steps_per_epoch:
                    _save_latest(latest_dir, state, epoch, step_i,
                                 best_det_acc, mesh)
                if step_i == epoch_start_step and epoch == start_epoch:
                    log_memory("VSM train, first step", plan, device)
                if step_i % 50 == 0 and main_rank:
                    progress.display(step_i)
                    _write_json({"epoch": epoch, "step": step_i,
                                 **{k: v.avg for k, v in meters.items()},
                                 "secs_per_batch": timer.batch_time.avg},
                                metrics_log, "a")
        finally:
            loader.close()

        # checkpoint (best-det-acc gating when a val set exists)
        det_acc = None
        if not args.no_eval:
            try:
                from ..data.val_dataset import ValDataset
                from .validate import validate
                val_ds = ValDataset(args.dataset_dir,
                                    clip_size=cfg.vision.image_size,
                                    owl_size=cfg.owl_vision.image_size)
                metrics_val = validate(
                    state.params, cfg,
                    val_ds.batches(tokenizer, loc_token_id,
                                   batch_size=args.batch_size,
                                   n_image_tokens=cfg.image_tokens,
                                   seq_bucket=args.seq_bucket),
                    lambda p, b: vsm_val_forward(
                        p, cfg, batch_to_torch(b, device)))
                det_acc = metrics_val["det_acc"]
                if main_rank:
                    print(f"[val] epoch {epoch}: {metrics_val}", flush=True)
            except FileNotFoundError:
                det_acc = None
        save = True if det_acc is None else det_acc > best_det_acc
        if save:
            if det_acc is not None:
                best_det_acc = det_acc
            os.makedirs(ckpt_dir, exist_ok=True)
            save_state(state, os.path.join(ckpt_dir, "state"), mesh)
            barrier(mesh)
            if main_rank:
                _write_json({"epoch": epoch, "det_acc": det_acc,
                             "best_det_acc": best_det_acc,
                             "mesh": mesh_dims(mesh)},
                            os.path.join(ckpt_dir, "meta.json"))
        if args.save_steps:
            # epoch-end rolling save regardless of best-gating, so a crash
            # early next epoch never replays this epoch's tail
            _save_latest(latest_dir, state, epoch, args.steps_per_epoch - 1,
                         best_det_acc, mesh)
    barrier(mesh)
    return state


def barrier(mesh) -> None:
    """Every rank's files are written before rank 0 writes the meta that
    points at them."""
    if mesh is not None:
        torch.distributed.barrier()


def _save_latest(latest_dir: str, state, epoch: int, step: int,
                 best_det_acc: float, mesh=None):
    os.makedirs(latest_dir, exist_ok=True)
    save_state(state, os.path.join(latest_dir, "state"), mesh)
    barrier(mesh)
    if is_main_process():
        _write_json({"epoch": epoch, "step": step,
                     "best_det_acc": best_det_acc, "mesh": mesh_dims(mesh)},
                    os.path.join(latest_dir, "meta.json"))


def main(argv=None, tokenizer=None, device="cuda"):
    """The VSM trainer from the command line: the model from the HF
    checkpoint directory --version on `device` (the card by default; under
    torchrun each rank's card), LoRA on the decoder, sharded over --mesh,
    then run_vsm_training. `tokenizer` None loads the checkpoint's (right
    padding, 512 tokens, unk as pad, as vstar_tpu loads it)."""
    from ..core.checkpoint import load_torch_dir
    from ..core.hf_config import vsm_config_for
    from ..models.vsm import vsm_params_from_torch
    from ..multimodal.tokenizer import load_tokenizer
    from .lora import add_lora
    args = parse_args(argv)
    device = rank_device(device)
    mesh = resolve_mesh(args.mesh, device)
    if tokenizer is None:
        tokenizer = load_tokenizer(args.version, model_max_length=512,
                                   padding_side="right")
        tokenizer.pad_token = tokenizer.unk_token
    loc_token_id = tokenizer("[LOC]", add_special_tokens=False).input_ids[0]
    cfg = vsm_config_for(args.version)
    param_dtype = torch.bfloat16 if args.param_dtype == "bf16" \
        else torch.float32
    params = vsm_params_from_torch(load_torch_dir(args.version, device), cfg,
                                   dtype=param_dtype)
    if args.lora_r > 0:
        params["llama"] = add_lora(params["llama"], 0, r=args.lora_r,
                                   alpha=args.lora_alpha)
    if mesh is not None:
        # the whole tree is dropped once each rank holds its shards
        params = shard_params(params, mesh)
    return run_vsm_training(args, cfg, params, tokenizer, loc_token_id)


if __name__ == "__main__":
    main()
