"""Serve a small model through the port's continuous-batching engine:
streamed outputs, per-request sampling, and copy-on-write prefix
sharing, compared across dense / CAMformer attention page layouts.  The
port of ``examples/serve_decode.py``.

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cuda]

Runs on one device, the card unless ``--device cpu`` is given (there is
no fallback: without a card the default raises).  ``--max-new`` cuts
the tokens a request generates (default 12).
"""

import argparse
import time

from repro_torch.configs import smoke_config
from repro_torch.models import init_params
from repro_torch.serving import Request, SamplingParams, ServeEngine

LAYOUTS = {
    "dense": "dense bf16 K/V pages",
    "binary": "dense bf16 K/V pages (HAD-binarized scoring)",
    "camformer": "packed binary K pages (6.25% of bf16) + top-32 sparse V",
}


def build(device, backend, layer_backends=None, **kw):
    cfg = smoke_config("codeqwen1.5-7b").replace(
        attn_backend=backend, layer_backends=layer_backends)
    params = init_params(cfg, device=device, seed=0)
    return cfg, ServeEngine(cfg, params, max_batch=4, max_len=96,
                            device=device, **kw)


def run(device, max_new, backend, layer_backends=None):
    cfg, eng = build(device, backend, layer_backends)
    prompts = [[7, 3, 9, 1], [5, 5, 2], [8, 1, 4, 4, 6], [2, 9],
               [1, 2, 3, 4, 5], [6, 6, 6]]
    for i, p in enumerate(prompts):
        eng.submit(Request(prompt=p, sampling=SamplingParams(
            max_new=max_new), rid=i))
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in done)
    label = ",".join(layer_backends) if layer_backends else backend
    layout = (" / ".join(LAYOUTS.get(b, b)
                         for b in dict.fromkeys(cfg.backend_names))
              if layer_backends else LAYOUTS.get(backend, backend))
    print(f"[{label:15s}] {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s); page layout: {layout}")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        print(f"   req {r.rid}: {r.prompt} -> {r.tokens}")


def run_streaming(device, max_new):
    """Tokens surface as they are generated."""
    _, eng = build(device, "camformer")
    reqs = [Request(prompt=[7, 3, 9, 1],
                    sampling=SamplingParams(max_new=max_new)),  # greedy
            Request(prompt=[5, 5, 2],
                    sampling=SamplingParams(temperature=0.8, top_k=40,
                                            top_p=0.95, max_new=max_new))]
    print("[streaming      ] ", end="")
    for out in eng.stream(*reqs):
        print(f"r{out.rid}:{out.token}", end=" ")
    print()


def run_prefix_sharing(device, max_new):
    """A shared 24-token system prompt is prefilled once: later requests
    alias its full pages (refcount++) and COW-fork the boundary page."""
    system = list(range(100, 124))
    prompts = [system + [i, 2 * i + 1] for i in range(1, 7)]
    stats = {}
    for share in (False, True):
        _, eng = build(device, "camformer", page_size=16,
                       prefix_sharing=share)
        for i, p in enumerate(prompts):
            eng.submit(Request(prompt=list(p), sampling=SamplingParams(
                max_new=max_new), rid=i))
        eng.run()
        stats[share] = eng.peak_pages
    print(f"[prefix sharing ] 6 requests x 26-token prompts (24 shared): "
          f"peak {stats[False]} pages independent vs {stats[True]} shared")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-new", type=int, default=12)
    args = ap.parse_args(argv)
    run(args.device, args.max_new, "dense")
    run(args.device, args.max_new, "camformer")
    # per-layer policy: both page layouts live in the same pool
    run(args.device, args.max_new, "dense",
        layer_backends=("dense", "camformer"))
    run_streaming(args.device, args.max_new)
    run_prefix_sharing(args.device, args.max_new)


if __name__ == "__main__":
    main()
