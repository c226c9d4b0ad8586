"""Serving driver of the port: continuous batching with streamed outputs.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch camformer-bert --backend camformer [--smoke] \
        [--layer-backends dense,camformer] [--mode overlap|sync] \
        [--prefill-slice 64] [--shared-prefix 32] [--no-stream] \
        [--temperature 0.8 --top-k 40 --top-p 0.95] \
        [--spec-k 3 --spec-backend binary] [--max-queue 8] \
        [--deadline-ms 500] [--faults step.error@3] [--device cuda|cpu]

    # tensor-parallel, one process a device (gloo with --device cpu)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch camformer-bert --smoke --tp 2 --device cpu

Serves the dense, MoE and VLM families (the VLM text-only, as the
reference does).  The encoder-decoder (``audio``/``encdec``), Griffin
(``hybrid``) and RWKV-6 (``ssm``) families have no paged interface, in
the reference either: the engine refuses them with its ValueError and
they run through the contiguous steps (launch/steps.py).  Runs on the
card by default; ``--device cpu`` runs the plain PyTorch path.  Weights are random, drawn from ``--seed`` (no weights ship with
the repository).  ``--temperature 0`` (the default) decodes greedily;
one sampling policy applies to every CLI request.  ``--spec-k N`` turns
on self-speculative decoding with an ``--spec-backend`` drafter.
``--max-queue``, ``--deadline-ms`` and ``--faults`` are the reference's
admission bound, per-request deadline and chaos fault plan.  ``--tp N``
head-shards the page pools over N processes (serving/sharded.py): rank 0
submits the requests and prints; the other ranks run the engine loop on
rank 0's tick inputs (``ServeEngine.follow``) and print nothing.  The
flags are the reference launcher's, plus ``--device`` and ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.launch.cli import add_engine_args, build_engine
from repro_torch.serving import Request, SamplingParams


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_engine_args(ap, max_batch=4, max_len=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="common system-prompt length prepended to every "
                         "request (exercises COW prefix sharing)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline: requests not finished "
                         "within this many ms of submit end with "
                         "finish_reason='timeout'")
    ap.add_argument("--no-stream", action="store_true",
                    help="suppress per-token output, print only summaries")
    args = ap.parse_args(argv)

    eng = build_engine(args)
    if eng.tp_rank > 0:
        eng.follow()
        return eng
    cfg = eng.cfg
    layout = cfg.uniform_backend or ",".join(cfg.layer_backends)
    shard = (f", head-sharded tp={eng.tp} over {eng.tp} processes"
             if eng.tp > 1 else "")
    print(f"paged KV cache [{layout}] on {eng.device}: {eng.kv.n_pages} "
          f"pages x {eng.kv.page_size} tokens "
          f"(page table {eng.kv.table.shape}{shard})")
    sampling = SamplingParams(max_new=args.max_new,
                              temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, deadline_ms=args.deadline_ms)
    rng = np.random.default_rng(7)
    shared = list(range(1, args.shared_prefix + 1))
    for i in range(args.requests):
        plen = 4 + int(rng.integers(0, 12))
        prompt = shared + [int(t) for t in rng.integers(0, cfg.vocab, plen)]
        eng.submit(Request(prompt=prompt, sampling=sampling, rid=i))
    t0 = time.perf_counter()
    for out in eng.stream():
        if not args.no_stream:
            tail = f"  [{out.finish_reason}]" if out.finished else ""
            print(f"  req {out.rid} #{out.index}: {out.token}{tail}")
    wall = time.perf_counter() - t0
    eng.close()
    print(f"[{args.mode}] {eng.ticks} decode ticks in {wall:.2f}s "
          f"({eng.ticks / max(wall, 1e-9):.1f} ticks/s), "
          f"{eng.readbacks} readbacks, host blocked "
          f"{eng.blocked_s / max(wall, 1e-9):.0%}")
    if eng.spec_k:
        print(f"speculation: k={eng.spec_k}, "
              f"{eng.spec_accepted}/{eng.spec_proposed} drafts accepted "
              f"({eng.spec_acceptance:.0%})")
    if eng.tick_errors or eng.sched.timeouts or eng.sched.rejections:
        print(f"chaos: {eng.tick_errors} tick errors contained "
              f"(last: {eng.last_error}), "
              f"{eng.sched.timeouts} timeouts, "
              f"{eng.sched.rejections} rejections")
    print(f"peak pool residency: {eng.peak_pages}/{eng.kv.n_pages - 1} pages"
          f" ({eng.kv.shared_pages} still shared, "
          f"{eng.kv.retained_pages} prefix pages retained at drain)")
    for r in sorted(eng.done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt[{len(r.prompt)}] "
              f"prefix_hit={r.prefix_matched} -> {r.tokens}")
    return eng


if __name__ == "__main__":
    main()
