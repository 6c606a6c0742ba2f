"""Merge-and-export command line (port of vstar_tpu/train/export_main.py,
the counterpart of VisualSearch/merge_lora_weights_and_save_hf_model.py).

Reads a VSM training checkpoint of the port (train_vsm_main's
ckpt_model/state: the file a one-device run writes, or the directory
the ranks of a mesh write, core/checkpoint.py) whole, in one process
without torchrun, merges the LoRA adapters into the base decoder and
writes a torch-layout safetensors checkpoint that the port's loaders
(core/checkpoint.load_torch_dir) or the torch reference load. The base
HF directory's config.json, if it has one, is copied beside the shards,
so the export loads with the base's shape. A VSM finetuned under
`torchrun ... train_vsm_main --mesh 1x4x1` exports so:

  python -m vstar_tpu_torch.train.export_main \\
      --ckpt runs/vsm/ckpt_model/state --version <base seal_vsm dir> \\
      --save_path ./exported_vsm

(CPU test: tests/test_torch_mesh.py, a checkpoint written at 2x2x1
exported bit for bit as the same state written on one device.)
"""

from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None):
    p = argparse.ArgumentParser("merge lora + export HF checkpoint")
    p.add_argument("--ckpt", required=True,
                   help="the trainer's state file (ckpt_model/state)")
    p.add_argument("--version", required=True,
                   help="base HF checkpoint dir (its config.json is "
                        "copied)")
    p.add_argument("--save_path", required=True)
    p.add_argument("--lora_r", default=8, type=int)
    p.add_argument("--lora_alpha", default=16, type=int)
    args = p.parse_args(argv)

    from ..core.checkpoint import load_params
    from ..core.hf_export import save_safetensors, vsm_state_dict
    from .vsm_train import VSMTrainState

    # the port's checkpoint holds the whole tree (LoRA included) with its
    # global shapes, so it needs no template built from the base weights
    # as Orbax does; --lora_r / --lora_alpha are kept for vstar_tpu's
    # command line
    state = VSMTrainState(*load_params(args.ckpt))
    has_lora = "lora" in state.params["llama"]["layers"]["attn"]
    if has_lora != (args.lora_r > 0):
        raise ValueError(f"--lora_r {args.lora_r}: the checkpoint "
                         f"{'has' if has_lora else 'has no'} LoRA adapters")
    sd = vsm_state_dict(state.params)   # merges LoRA inside llama export
    save_safetensors(sd, args.save_path)
    config = os.path.join(args.version, "config.json")
    if os.path.isfile(config):
        shutil.copy(config, args.save_path)
    print(f"exported {len(sd)} tensors to {args.save_path}")
    return sd


if __name__ == "__main__":
    main()
