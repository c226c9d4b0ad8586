"""Gateway launcher of the port: serve a model over HTTP/SSE.

    PYTHONPATH=src python -m repro_torch.launch.gateway \\
        --arch camformer-bert [--smoke] [--backend camformer] \\
        [--host 127.0.0.1 --port 8000] [--max-batch 8 --max-len 256] \\
        [--mode overlap|sync] [--prefill-slice 64] \\
        [--paged-impl fused|gather] [--max-queue 16] \\
        [--faults 'gateway.disconnect@0::p0.1'] [--device cuda|cpu]

    # tensor-parallel, one process a device (gloo with --device cpu)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.gateway \
        --arch camformer-bert --smoke --tp 2 --device cpu --port 8000

Then point traffic at it:

    curl -N -X POST http://127.0.0.1:8000/v1/generate \\
        -d '{"prompt": [3, 5, 8, 1], "max_new": 16, "temperature": 0.8}'
    curl http://127.0.0.1:8000/healthz
    curl http://127.0.0.1:8000/metrics

Each generated token streams back as a server-sent event; closing the
connection mid-stream cancels the request and frees its pages.  Runs on
the card by default (``--device cpu`` runs the plain PyTorch path);
weights are random, drawn from ``--seed``.  ``--tp N`` head-shards the
page pools over N processes (serving/sharded.py): rank 0 serves HTTP and
drives the engine; the other ranks run its ticks on rank 0's inputs
(``ServeEngine.follow``) until it stops.  The flags are the reference
launcher's, plus ``--device`` and ``--seed``.
"""

from __future__ import annotations

import argparse
import asyncio

from repro_torch.launch.cli import add_engine_args, build_engine
from repro_torch.serving.gateway import Gateway


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    add_engine_args(ap, max_batch=8, max_len=256)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000, help="0 = pick a free port")
    args = ap.parse_args(argv)

    engine = build_engine(args)
    if engine.tp_rank > 0:
        engine.follow()
        return
    layout = engine.cfg.uniform_backend or ",".join(engine.cfg.layer_backends)

    async def serve() -> None:
        gw = Gateway(engine, host=args.host, port=args.port)
        await gw.start()
        shard = f", head-sharded tp={engine.tp}" if engine.tp > 1 else ""
        print(
            f"gateway [{layout}] listening on http://{args.host}:{gw.port} "
            f"(pool {engine.kv.n_pages - 1} pages x {engine.kv.page_size} "
            f"tokens, {args.mode} loop on {engine.device.type}{shard})",
            flush=True,
        )
        try:
            await gw.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            await gw.aclose()

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        print("gateway stopped")
    finally:
        engine.close()  # the engine thread has stopped: release the ranks


if __name__ == "__main__":
    main()
