"""SEAL serving on the port: stdlib HTTP JSON API (port of
vstar_tpu/serve/server.py).

Request:  {"image": <base64 jpg/png>, "question": str, "options": [str]?}
Response with options: the SEAL record ("prediction_freeform",
          "missing_objects", "search_result", "option_chosen", ...);
          without: the free-form record ("freeform", "answer",
          "missing_objects", "failed_objects", "search_result"); both
          with "latency_s".

    python -m vstar_tpu_torch.serve.server --random-init 7b --device cuda
    python -m vstar_tpu_torch.serve.server --random-init 7b --int4mix
    python -m vstar_tpu_torch.serve.server --random-init 7b \
        --device-preprocess --warmup --max-batch 8
    python -m vstar_tpu_torch.serve.server --random-init 7b --continuous \
        --max-batch 8 --window-ms 8
    python -m vstar_tpu_torch.serve.server --random-init 7b --kv-int8

The VSM engine is a BatchedVSMEngine, as in vstar_tpu: the searches of a
request's missing objects advance in lockstep waves, one device batch
per wave. --continuous serves through serve/continuous.py's
ContinuousSealService: concurrent requests co-batch in waves of up to
--max-batch, formed within --window-ms of the first arrival.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence

import torch
from PIL import Image

from ..data.preprocess import expand2square
from ..eval.batched_bench import build_focus_inputs, run_search_phase
from ..eval.seal import parse_missing_objects, seal_answer
from .sanitize import sanitize_text


class SealService:
    def __init__(self, vqa_engine, vsm_engine, minimum_size_scale=4.0,
                 minimum_size=224, max_search_steps: Optional[int] = None):
        self.vqa = vqa_engine
        self.vsm = vsm_engine
        self.minimum_size_scale = minimum_size_scale
        self.minimum_size = minimum_size
        self.max_search_steps = max_search_steps
        # one request at a time on the device
        self._lock = threading.Lock()

    def answer(self, image: Image.Image, question: str,
               options: Optional[Sequence[str]] = None) -> Dict:
        question = sanitize_text(question)
        t0 = time.perf_counter()
        with self._lock:
            if options:
                rec = seal_answer(self.vqa, self.vsm, image, question,
                                  [sanitize_text(o) for o in options],
                                  self.minimum_size_scale,
                                  self.minimum_size, self.max_search_steps)
            else:
                rec = self._freeform_flow(image, question)
        rec["latency_s"] = round(time.perf_counter() - t0, 4)
        return rec

    def _freeform_flow(self, image: Image.Image, question: str) -> Dict:
        """app.py:130-233 without the option scorer: answer, search when
        objects are missing, then re-answer with focus crops. As the
        reference does, an unsuccessful search lands in failed_objects
        AND keeps its low-confidence fallback box (app.py:165-179), and
        the focus message carries the 'not existent in the image' clause
        (app.py:215-223)."""
        squared, _, _ = expand2square(image)
        prediction = self.vqa.free_form(squared, question)
        missing = parse_missing_objects(prediction)
        srs, fls = run_search_phase(
            self.vsm, [image], [missing], self.minimum_size_scale,
            self.minimum_size, self.max_search_steps)
        search_result, failed = srs[0], fls[0]
        answer = prediction
        if missing and search_result:
            squared, q, crops, il, ol = build_focus_inputs(
                self.vqa, image, question, search_result, failed,
                include_failed=True)
            answer = self.vqa.free_form(squared, q, object_crops=crops,
                                        images_long=il, objects_long=ol)
        return {"freeform": prediction, "answer": answer,
                "missing_objects": missing, "failed_objects": failed,
                "search_result": search_result}


def _make_handler(service: SealService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/answer":
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                img = Image.open(io.BytesIO(
                    base64.b64decode(req["image"]))).convert("RGB")
                rec = service.answer(img, req["question"],
                                     req.get("options"))
            except Exception as e:  # the request's fault: report, keep serving
                self._reply(400, {"error": str(e)})
                return
            self._reply(200, rec)

    return Handler


def make_server(service: SealService, host: str = "0.0.0.0",
                port: int = 8080) -> ThreadingHTTPServer:
    """A bound server (port 0 picks a free one; see .server_address)."""
    return ThreadingHTTPServer((host, port), _make_handler(service))


def serve(service: SealService, host: str = "0.0.0.0", port: int = 8080):
    httpd = make_server(service, host, port)
    print(f"seal server on {host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


def check_random_init(size: str, device) -> None:
    """Raise ValueError for a --random-init size the device cannot run:
    'tiny' is an f32 CPU smoke at head_dim 16, and the CUDA attention
    kernels take bf16 at head_dim 128 (no wrapper falls back to its plain
    version on a CUDA tensor)."""
    if size not in ("tiny", "7b"):
        raise ValueError(f"random init size {size!r}: 'tiny' or '7b'")
    if size == "tiny" and torch.device(device).type == "cuda":
        raise ValueError(
            "random init 'tiny' is an f32 CPU smoke at head_dim 16, and the "
            "CUDA attention kernels take bf16 at head_dim 128: pass "
            "--device cpu, or use '7b' on the card")


def random_init_engines(size: str, device, int8: bool = False,
                        int4: bool = False, mixed: bool = False,
                        int4mix: bool = False, prompt_lookup: bool = False,
                        device_preprocess: bool = False,
                        kv_int8: bool = False):
    """Checkpoint-free engines: the real model graphs with random weights
    drawn on `device` and the stub tokenizer, as vstar_tpu's
    --random-init builds them. 'tiny' is f32 and unquantized (a CPU
    smoke), '7b' the full-width seal_vqa_7b / seal_vsm_7b pair in bf16.

    The quantization flags resolve as vstar_tpu/serve/server.py does:
    int8 both decoders; int4 both (group-128 int4); mixed an int8 VQA
    decoder with an int4 VSM decoder and int8 towers; int4mix alone
    implies mixed with the VSM decoder in int4mix (int4 gate/up/lm_head,
    int8 qkvo/down). The default is bf16 (vstar_tpu defaults to int8,
    which a 16 GB TPU chip needs; the 80 GB card does not).

    Both engines keep their template drafts (the VQA engine drafts by
    prompt lookup instead with prompt_lookup), so the verify chunks run
    on this path too. vstar_tpu's random-init VSM turns its template off:
    random weights never answer it, and the tokens are the same. The VSM
    engine is a BatchedVSMEngine (device_preprocess: patches cut from a
    canvas of the image on the device). kv_int8: both engines keep int8
    KV caches with per-(token, head) scales."""
    from ..core.config import vqa_llm_7b, vqa_llm_tiny, vsm_7b, vsm_tiny
    from ..eval.vqa_engine import VQAEngine
    from ..models.vqa_llm import init_vqa_llm_params
    from ..models.vsm import init_vsm_params
    from ..multimodal.stub_tokenizer import StubTokenizer
    from ..nn.quant import quantize_model_towers
    from ..search.batched import BatchedVSMEngine

    check_random_init(size, device)
    tiny = size == "tiny"
    vqa_cfg = vqa_llm_tiny() if tiny else vqa_llm_7b()
    vsm_cfg = vsm_tiny() if tiny else vsm_7b()
    dtype = torch.float32 if tiny else torch.bfloat16
    mixed = mixed or (int4mix and not int4)
    int4mode = "int4mix" if int4mix else "int4"
    vqa_quant = (False if tiny else True if mixed
                 else int4mode if int4 else int8)
    vsm_quant = (False if tiny else int4mode if (int4 or mixed) else int8)
    tok = StubTokenizer(vqa_cfg.llama.vocab_size)
    vqa_params = init_vqa_llm_params(0, vqa_cfg, device=device, dtype=dtype,
                                     quantize_llm=vqa_quant)
    if mixed:
        # towers int8 before the second model builds, as vstar_tpu does
        vqa_params = quantize_model_towers(vqa_params)
    vsm_params = init_vsm_params(1, vsm_cfg, device=device, dtype=dtype,
                                 quantize_llm=vsm_quant)
    if mixed:
        vsm_params = quantize_model_towers(vsm_params)
    vqa = VQAEngine(vqa_params, vqa_cfg, tok, device=device,
                    prompt_buckets=(64,) if tiny else (512, 768),
                    option_bucket=16 if tiny else 64, compute_dtype=dtype,
                    prompt_lookup=prompt_lookup, kv_int8=kv_int8)
    vsm = BatchedVSMEngine(vsm_params, vsm_cfg, tok, loc_token_id=3,
                           device=device, eos_id=2,
                           max_new_tokens=4 if tiny else 16,
                           prompt_buckets=(64,) if tiny else (384,),
                           compute_dtype=dtype,
                           device_preprocess=device_preprocess,
                           kv_int8=kv_int8)
    return vqa, vsm


# the canvas buckets --warmup covers: 512-multiples up to 2K, both
# orientations of each non-square size (vstar_tpu/serve/server.py)
WARMUP_CANVAS_SIZES = ((512, 512), (1024, 1024), (1536, 2048),
                       (2048, 2048), (2048, 1536))


def warmup_engines(vqa, vsm, max_batch: int, log=print):
    """Both warmups over the batch buckets a wave of up to max_batch rows
    pads to, and the canvas sizes of WARMUP_CANVAS_SIZES; a compiled VSM
    (search/compiled.CompiledVSMSearch) also runs warmup_compiled over
    those canvas sizes and its batch buckets, capturing the decode graph
    of every shape a search can take."""
    from ..eval.vqa_engine import warmup_vqa_engine
    from ..search.batched import (BATCH_BUCKETS, _batch_bucket,
                                  warmup_vsm_engine)
    from ..search.compiled import CompiledVSMSearch, warmup_compiled
    top = _batch_bucket(max(max_batch, 1))
    buckets = tuple(b for b in BATCH_BUCKETS if b <= top)
    warmup_vqa_engine(vqa, batch_buckets=buckets, log=log)
    comp = vsm if isinstance(vsm, CompiledVSMSearch) else None
    warmup_vsm_engine(vsm if comp is None else comp.engine,
                      batch_buckets=buckets,
                      canvas_sizes=WARMUP_CANVAS_SIZES, log=log)
    if comp is not None:
        warmup_compiled(comp, canvas_sizes=WARMUP_CANVAS_SIZES,
                        batch_buckets=tuple(b for b in comp.BATCH_BUCKETS
                                            if b <= top) or (1,), log=log)
    if log:
        for name, eng in (("vqa", vqa), ("vsm", vsm if comp is None
                                         else comp.engine)):
            g = eng.graphs
            log(f"[warmup] {name} decode graphs: {g.kept} kept of "
                f"{g.captures} captured, cache slabs "
                f"{g.cache_bytes() / 2**20:.1f} MiB")


def add_engine_flags(p):
    """The engine flags every serving command line shares (the server and
    serve/demo.py), under vstar_tpu's names."""
    p.add_argument("--random-init", choices=["tiny", "7b"], required=True,
                   help="random weights + the stub tokenizer (loading "
                        "checkpoints is not ported yet)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 decoders (default: bf16)")
    p.add_argument("--int4", action="store_true",
                   help="group-128 int4 decoders (kernels K5/K6)")
    p.add_argument("--mixed", action="store_true",
                   help="int8 VQA decoder + int4 VSM decoder + int8 towers")
    p.add_argument("--int4mix", action="store_true",
                   help="int4 gate/up/lm_head and int8 qkvo/down on the "
                        "int4 side; alone it implies --mixed")
    p.add_argument("--kv-int8", dest="kv_int8", action="store_true",
                   help="int8 KV caches with per-(token, head) scales "
                        "(about half the cache bytes; not bitwise the "
                        "bf16 cache's answers)")
    p.add_argument("--prompt-lookup", action="store_true",
                   help="prompt-lookup drafts for free-form answers in "
                        "place of the template (the same tokens; the "
                        "speed depends on how much answers echo the "
                        "prompt)")
    p.add_argument("--device-preprocess", action="store_true",
                   help="cut search patches out of a device canvas of the "
                        "image (one upload per image) instead of on the "
                        "host")
    p.add_argument("--compiled", action="store_true",
                   help="whole searches as device steps (the policy, the "
                        "windows and the VSM on the card, batched across "
                        "a request's missing objects); implies "
                        "--device-preprocess")
    p.add_argument("--warmup", action="store_true",
                   help="run every (mode x batch bucket x prompt bucket) "
                        "and the canvas sizes up to 2K once before serving")


def engines_from_flags(args, max_batch: int = 1):
    """add_engine_flags' arguments -> the (vqa, vsm) pair; vsm is a
    CompiledVSMSearch under --compiled. max_batch sizes the warmup's
    batch buckets (waves pad up to the covering bucket). Raises
    ValueError for a --random-init size the device cannot run
    (check_random_init)."""
    vqa, vsm = random_init_engines(args.random_init, args.device,
                                   int8=args.int8, int4=args.int4,
                                   mixed=args.mixed, int4mix=args.int4mix,
                                   prompt_lookup=args.prompt_lookup,
                                   device_preprocess=args.device_preprocess
                                   or args.compiled,
                                   kv_int8=args.kv_int8)
    if args.compiled:
        from ..search.compiled import CompiledVSMSearch
        vsm = CompiledVSMSearch(vsm)
    if args.warmup:
        warmup_engines(vqa, vsm, max_batch)
    return vqa, vsm


def main():
    import argparse
    p = argparse.ArgumentParser("seal serving (PyTorch port)")
    add_engine_flags(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", default=8080, type=int)
    p.add_argument("--continuous", action="store_true",
                   help="continuous request batching: concurrent requests "
                        "co-batch on the device instead of serializing")
    p.add_argument("--max-batch", default=8, type=int,
                   help="the widest wave: --continuous forms waves of up "
                        "to this many requests, --warmup covers its batch "
                        "bucket and the buckets below")
    p.add_argument("--window-ms", default=8.0, type=float,
                   help="--continuous: how long a wave waits for more "
                        "requests after its first")
    args = p.parse_args()
    try:
        check_random_init(args.random_init, args.device)
    except ValueError as e:
        p.error(str(e))
    vqa, vsm = engines_from_flags(args, max_batch=args.max_batch)
    if args.continuous:
        from .continuous import ContinuousSealService
        service = ContinuousSealService(vqa, vsm, max_batch=args.max_batch,
                                        window_ms=args.window_ms)
    else:
        service = SealService(vqa, vsm)
    serve(service, args.host, args.port)


if __name__ == "__main__":
    main()
