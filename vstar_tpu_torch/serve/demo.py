"""Interactive SEAL demo, counterpart of the reference app.py (port of
vstar_tpu/serve/demo.py).

With gradio installed: the same interface (image + question -> direct
answer, search trigger, bbox visualization, focused re-answer). Without
gradio: a terminal REPL over the identical SealService flow, writing bbox
visualizations to disk.

    python -m vstar_tpu_torch.serve.demo --vqa-model-path <hf dir> \
        --vsm-model-path <hf dir>
    python -m vstar_tpu_torch.serve.demo --random-init 7b
    torchrun --nproc-per-node N -m vstar_tpu_torch.serve.demo \
        --vqa-model-path <hf dir> --vsm-model-path <hf dir> --mesh 1xNx1

Under --mesh the front end runs on rank 0 and the other ranks follow it
(serve/ranks.py).
"""

from __future__ import annotations

import argparse
import os

from PIL import Image

from ..search.visualize import draw_bbox
from .server import SealService


TITLE = "V*: Guided Visual Search as a Core Mechanism in Multimodal LLMs"
DESCRIPTION = (
    "Ask about a small visual detail. The VQA LLM answers directly when "
    "it can; otherwise it names the missing objects, the VSM's guided "
    "search localizes them, and the model re-answers focused on the "
    "found crops. Four outputs, as in the reference demo: the direct "
    "answer / search trigger, the search outcome text, the located "
    "boxes, and the final focused answer.")


def demo_outputs(service: SealService, image, question):
    """The reference demo's four outputs (app.py:158-233): (direct answer
    or search-trigger text, search outcome text, bbox visualization,
    focused final answer). Non-search questions return (answer, None,
    None, None) exactly like app.py:156."""
    rec = service.answer(image, question)
    if rec.get("error"):
        return f"[Error] {rec['error']}", None, None, None
    if not rec.get("missing_objects"):
        return rec.get("freeform"), None, None, None
    trigger = ("Need to conduct visual search to search for: {}."
               .format(", ".join(rec["missing_objects"])))
    located = [r["name"] for r in rec.get("search_result", [])]
    failed = rec.get("failed_objects", [])
    outcome = ""
    if located:
        outcome += ("Targets located after search: {}."
                    .format(", ".join(located)))
    if failed:
        outcome += ("Targets unable to locate after search: {}."
                    .format(", ".join(failed)))
    vis = image
    for r in rec.get("search_result", []):
        vis = draw_bbox(vis, r["bbox"], r["name"])
    return trigger, outcome, vis, rec.get("answer")


def load_examples(examples_dir):
    """Curated examples gallery (app.py:62-107): examples.json in the
    directory holds [[question, image_filename], ...]; without it, every
    image file pairs with a generic detail question."""
    import json
    if not examples_dir or not os.path.isdir(examples_dir):
        return None
    manifest = os.path.join(examples_dir, "examples.json")
    if os.path.exists(manifest):
        rows = json.load(open(manifest))
        return [[q, os.path.join(examples_dir, f)] for q, f in rows]
    exts = (".jpg", ".jpeg", ".png", ".webp")
    imgs = sorted(f for f in os.listdir(examples_dir)
                  if f.lower().endswith(exts))
    return [["What is the small object in this image?",
             os.path.join(examples_dir, f)] for f in imgs] or None


def run_cli(service: SealService, out_dir: str = "./demo_out"):
    os.makedirs(out_dir, exist_ok=True)
    print("SEAL demo — enter '<image_path> :: <question>' (empty to quit)")
    i = 0
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line:
            break
        if "::" not in line:
            print("format: <image_path> :: <question>")
            continue
        path, question = [s.strip() for s in line.split("::", 1)]
        try:
            image = Image.open(path).convert("RGB")
        except Exception as e:
            print(f"cannot open image: {e}")
            continue
        direct, outcome, vis, final = demo_outputs(service, image, question)
        print("direct answer:", direct)
        if outcome is not None:
            print("search result:", outcome)
            out = os.path.join(out_dir, f"search_{i}.jpg")
            vis.save(out)
            print("search result boxes ->", out)
            print("final answer:", final)
        i += 1


def launch_gradio(service: SealService,
                  examples_dir=None):  # pragma: no cover - needs gradio
    import gradio as gr

    def infer(question, image):
        if image is None or not (question or "").strip():
            return "[Error] provide an image and a question", None, None, \
                None
        return demo_outputs(service, image, question)

    demo = gr.Interface(
        fn=infer,
        inputs=[gr.Textbox(lines=1, label="Text Instruction"),
                gr.Image(type="pil", label="Input Image")],
        outputs=[gr.Textbox(lines=1, label="Direct Answer"),
                 gr.Textbox(lines=1, label="Visual Search Results"),
                 gr.Image(type="pil", label="Visual Search Results"),
                 gr.Textbox(lines=1, label="Final Answer")],
        examples=load_examples(examples_dir),
        title=TITLE,
        description=DESCRIPTION,
    )
    demo.queue().launch()


def main():
    from .ranks import follow, for_engines
    from .server import add_engine_flags, check_engine_flags, \
        engines_from_flags
    p = argparse.ArgumentParser("seal demo (PyTorch port)")
    add_engine_flags(p)
    p.add_argument("--examples-dir", default=None,
                   help="directory of example images (+ optional "
                        "examples.json [[question, file], ...]) for the "
                        "gradio gallery")
    args = p.parse_args()
    try:
        check_engine_flags(args)
    except ValueError as e:
        p.error(str(e))
    # the server's engine flags: the weight formats, --kv-int8, --mesh,
    # and --warmup running every shape once before the first question
    vqa, vsm = engines_from_flags(args)
    ranks = for_engines(vqa, vsm)
    service = SealService(vqa, vsm, ranks=ranks)
    if ranks is not None:
        if not ranks.leader:
            follow(service, ranks)
            return
        ranks.start_heartbeat()
    try:
        try:
            import gradio  # noqa: F401
        except ImportError:
            run_cli(service)
        else:
            launch_gradio(service, examples_dir=args.examples_dir)
    finally:
        if ranks is not None:
            ranks.stop()


if __name__ == "__main__":
    main()
