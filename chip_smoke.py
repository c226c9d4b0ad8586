"""Run the PyTorch/CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py            # every phase, exits 0 only if all pass

Phases, in order (each raises on failure; nothing is caught):

  1. the card's name and power limit (``nvidia-smi``);
  2. build both CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, started together) into ``build/``;
  3. kernels: at the serving shapes, each kernel against its plain
     PyTorch version on the same inputs on the card (bit-exact for the
     integer CAM candidates, 1e-5 for the flash rows), then CUDA-event
     times of kernel, plain version and one PyTorch library call;
  4. parity: a small-width model's logits on the card (kernel path)
     against the same model on the CPU (plain path);
  5. slice: ``camformer-bert`` at full width in bf16 with seeded random
     weights, served by ``ServeEngine`` (8 slots, 1024 tokens, overlap
     mode) for 8 greedy requests, once on ``camformer`` and once on
     ``dense``, checking finish reasons, tick errors, one readback per
     tick and that each kernel of the path was launched.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository next to this file, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # non-tensor-core float32: the kernels' arithmetic
INT32_OP_PER_S = 67e12  # scalar integer ops issue at the same rate class

SEED = 0


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, *, n=30, warmup=3, flush=None):
    """Median CUDA-event time of fn() in ms; ``flush`` (a large buffer)
    is overwritten before every timed launch so L2 starts cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ragged_pool(gen, b, hkv, page, np_, kv_len, dtype, width):
    """A pool whose live pages are a random permutation of physical pages
    1.. per slot; table entries past kv_len point at trash page 0."""
    n_pages = 1 + b * np_
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    table = perm.reshape(b, np_).to(torch.int32)
    for i, n in enumerate(kv_len):
        table[i, -(-int(n) // page):] = 0
    pool = torch.randn((n_pages, hkv, page, width), generator=gen)
    return pool.to(dtype), table


def causal_keys(kv_len, q_pos, sq):
    """(row, key) pairs the function needs per head: row s of a slot sees
    min(kv_len, q_pos + s + 1) keys."""
    s = torch.arange(sq)
    n = torch.minimum(kv_len[:, None].long(), q_pos[:, None].long() + s + 1)
    return int(n.clamp(min=0).sum())


def close(got, want, tol):
    err = (got.float() - want.float()).abs()
    bad = err > tol + tol * want.float().abs()
    return float(err.max()), not bool(bad.any())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions

# the slice phase's prompt lengths; its prefill tick runs them as one
# chunk of Sq = 384 rows at q_pos 0, and its decode ticks at lens + t
SLICE_LENS = [64, 96, 128, 192, 256, 320, 352, 384]
MID_DECODE = 16  # decode step whose kv_len the decode kernels are timed at


def kernel_phase(flush):
    from repro_torch.core.bacam import pack_bits
    from repro_torch.kernels import bacam_decode as bdec
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.kernels.ref import MASKED_SCORE

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    lens = torch.tensor(SLICE_LENS, dtype=torch.int32)
    ragged = torch.tensor([1024, 700, 513, 64, 1, 0, 300, 0],
                          dtype=torch.int32)
    decode_len = lens + MID_DECODE

    # --- bacam stage-1 at the decode shapes: 8 slots, 16 kv heads, R = 1,
    # W = 2 (d = 64), 64-key pages, 16 pages (1024 tokens).  Checked on
    # ragged + inert slots with each option, and at the slice's mid-decode
    # kv_len, which is also the timed case.
    b, hkv, r, d, page, np_ = 8, 16, 1, 64, 64, 16
    default = dict(group=16, stage1_k=2, window=None)
    cases = [(ragged, default), (ragged, dict(group=16, stage1_k=2,
                                              window=100)),
             (ragged, dict(group=4, stage1_k=3, window=None)),
             (decode_len, default)]
    for kv_len, kw in cases:
        kp, table = ragged_pool(gen, b, hkv, page, np_, kv_len,
                                torch.float32, d)
        kp = pack_bits(kp)
        q = pack_bits(torch.randn((b, hkv, r, d), generator=gen))
        q_pos = torch.clamp(kv_len - 1, min=0)
        args = [t.to(dev).contiguous() for t in (q, kp, table, kv_len, q_pos)]
        got_v, got_i = bdec.bacam_paged_topk_stage1(*args, d=d, **kw)
        want_v, want_i = bdec.bacam_paged_topk_ref(
            args[0], args[1], args[2], args[3], d, q_pos=args[4],
            group_size=kw["group"], stage1_k=kw["stage1_k"],
            window=kw["window"])
        torch.cuda.synchronize()
        valid = want_v > MASKED_SCORE // 2
        assert torch.equal(got_v, want_v), f"bacam values differ {kw}"
        assert torch.equal(got_i[valid], want_i[valid]), \
            f"bacam indices differ on valid candidates {kw}"
        log(f"bacam_paged_topk_stage1 kv_len {kv_len.tolist()} {kw}: "
            f"bit-exact ({int(valid.sum())} valid candidates)")
    # args, q, kv_len, q_pos are now the mid-decode case
    kern = lambda: bdec.bacam_paged_topk_stage1(*args, d=d)
    plain = lambda: bdec.bacam_paged_topk_ref(
        args[0], args[1], args[2], args[3], d, q_pos=args[4])
    keys = causal_keys(kv_len, q_pos, 1)
    ncand = 2 * (page // 16) * np_
    bytes_ = (q.numel() * 4 + keys * hkv * (d // 32) * 4
              + table.numel() * 4 + 2 * b * 4 + 2 * b * hkv * r * ncand * 4)
    ops = 3 * keys * hkv * r * (d // 32)  # xor, popc, add per word
    rows.append(dict(
        name="bacam_paged_topk_stage1", route="cuda",
        source="src/repro_torch/csrc/bacam_decode.cu",
        replaces="src/repro/kernels/bacam_decode.py:137",
        max_abs_err=0.0, ms=cuda_ms(kern, flush=flush),
        plain_ms=cuda_ms(plain, flush=flush),
        **bound(bytes_, ops / INT32_OP_PER_S), library_ms=None))

    # --- paged flash attention on bf16 pools.  The two cases with a name
    # are the slice's own (mid-decode, and its one prefill chunk: 384
    # rows at q_pos 0, padding rows past each prompt) and are timed; the
    # others are checked only (ragged + inert slots, nonzero offsets).
    offsets = torch.tensor([0, 256, 384, 0, 128, 0, 640, 0],
                           dtype=torch.int32)
    live = torch.tensor([1, 1, 1, 1, 1, 0, 1, 0], dtype=torch.int32)
    flash_cases = [
        (None, 1, ragged, torch.clamp(ragged - 1, min=0)),
        (None, 128, (offsets + 128) * live, offsets),
        ("paged_flash_decode", 1, decode_len, decode_len - 1),
        ("paged_flash_decode (sq>1)", 384, lens, torch.zeros_like(lens)),
    ]
    for name, sq, kv_len, q_pos in flash_cases:
        kpool, table = ragged_pool(gen, b, hkv, page, np_, kv_len,
                                   torch.bfloat16, d)
        vpool, _ = ragged_pool(gen, b, hkv, page, np_, kv_len,
                               torch.bfloat16, d)
        qr = torch.randn((b, hkv, sq, d), generator=gen) * d**-0.5
        a = [t.to(dev).contiguous()
             for t in (qr, kpool, vpool, table, kv_len, q_pos)]
        got = pfd.paged_flash_decode(*a, sq=sq)
        want = pfd.paged_flash_decode_ref(*a, sq=sq)
        err, ok = close(got, want, 1e-5)
        label = f"paged_flash_decode sq={sq} kv_len {kv_len.tolist()}"
        assert ok, f"{label} bf16 pools: max abs err {err}"
        inert = (kv_len == 0).to(dev)
        assert torch.all(got[inert] == 0), f"{label}: inert rows not zero"
        log(f"{label} bf16 pools: max abs err {err:.3g} (tol 1e-5 rel+abs)")
        if name is None:
            continue
        kern = lambda: pfd.paged_flash_decode(*a, sq=sq)
        plain = lambda: pfd.paged_flash_decode_ref(*a, sq=sq)
        library = library_attention(a, sq)
        keys = sum(int(n) for n in kv_len)
        bytes_ = (qr.numel() * 4 + 2 * keys * hkv * d * 2
                  + table.numel() * 4 + 2 * b * 4 + got.numel() * 4)
        # QK^T and PV, 2 FLOPs per multiply-add, over causal (row, key)
        flops = 2 * 2 * causal_keys(kv_len, q_pos, sq) * hkv * d
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/paged_flash_decode.cu",
            replaces="src/repro/kernels/paged_flash_decode.py:228",
            max_abs_err=err, ms=cuda_ms(kern, flush=flush),
            plain_ms=cuda_ms(plain, flush=flush),
            **bound(bytes_, flops / F32_FLOP_PER_S),
            library_ms=cuda_ms(library, flush=flush)))

    # --- options at small shapes: f32 pools, GQA rows, binary, window
    b, hkv, g, d, page, np_ = 3, 2, 4, 32, 8, 4
    kv_len = torch.tensor([16, 0, 21], dtype=torch.int32)
    for sq in (1, 3):
        for binary, window in ((False, None), (True, None), (False, 5),
                               (True, 7)):
            kpool, table = ragged_pool(gen, b, hkv, page, np_, kv_len,
                                       torch.float32, d)
            vpool, _ = ragged_pool(gen, b, hkv, page, np_, kv_len,
                                   torch.float32, d)
            qr = torch.randn((b, hkv, g * sq, d), generator=gen)
            q_pos = torch.clamp(kv_len - sq, min=0)
            a = [t.to(dev).contiguous()
                 for t in (qr, kpool, vpool, table, kv_len, q_pos)]
            kw = dict(sq=sq, binary=binary, window=window)
            got = pfd.paged_flash_decode(*a, **kw)
            want = pfd.paged_flash_decode_ref(*a, **kw)
            err, ok = close(got, want, 1e-5)
            assert ok, f"flash f32 {kw}: max abs err {err}"
            assert torch.all(got[1] == 0), f"flash f32 {kw}: inert row"
    log("paged_flash_decode f32 pools, G=4, binary/window, sq 1 and 3: "
        "within 1e-5")
    torch.cuda.synchronize()
    return rows


def bound(bytes_, op_s):
    byte_s = bytes_ / HBM_BYTES_PER_S
    return dict(bound_ms=max(byte_s, op_s) * 1e3,
                bound_by="bytes" if byte_s >= op_s else "operations")


def library_attention(a, sq):
    """One PyTorch call computing the same attention on K/V gathered
    into logical order beforehand (a yardstick; the port never calls
    it).  Masked keys get -inf through a boolean mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import paged_gather_ref

    qr, kpool, vpool, table, kv_len, q_pos = a
    k = paged_gather_ref(kpool, table).float()
    v = paged_gather_ref(vpool, table).float()
    s_log = k.shape[2]
    kpos = torch.arange(s_log, device=qr.device)
    qrow = q_pos[:, None] + torch.arange(qr.shape[2], device=qr.device) % sq
    mask = (kpos[None, None] < kv_len[:, None, None]) & \
        (kpos[None, None] <= qrow[:, :, None])
    mask = mask[:, None] | (kv_len == 0)[:, None, None, None]
    return lambda: F.scaled_dot_product_attention(qr, k, v, attn_mask=mask,
                                                  scale=1.0)


# ---------------------------------------------------------------------------
# phase 4: small-width parity, card against CPU


def parity_phase():
    from repro_torch.configs import smoke_config
    from repro_torch.models import (cast_params, init_params, init_pools,
                                    lm_decode_paged, lm_page_specs,
                                    lm_prefill_paged)

    for arch in ("camformer-bert", "mistral-nemo-12b"):
        for backend in ("dense", "camformer"):
            cfg = smoke_config(arch, attn_backend=backend)
            params = init_params(cfg, device="cpu", seed=SEED)
            rng = np.random.default_rng(SEED)
            b, s, page, np_ = 3, 20, 8, 6
            table = np.zeros((b, np_), np.int32)
            table[:] = 1 + np.arange(b * np_).reshape(b, np_)
            lens = np.array([20, 13, 0], np.int32)
            tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)
            logits, fed = {}, []  # both devices are fed the CPU's picks
            for devname in ("cpu", "cuda"):
                dev = torch.device(devname)
                p = cast_params(params, torch.float32, dev)
                pools = init_pools(lm_page_specs(cfg, 1 + b * np_, page, b),
                                   dev)
                pt = torch.from_numpy(table).to(dev)
                batch = {"tokens": torch.from_numpy(tokens).to(dev),
                         "lens": torch.from_numpy(lens).to(dev)}
                out = [lm_prefill_paged(p, batch, pools, pt, cfg)[0]]
                pos = torch.from_numpy(lens).to(dev)
                for step in range(3):
                    if devname == "cpu":
                        fed.append(torch.argmax(out[-1], -1).to(torch.int32))
                    tok = fed[step].to(dev)
                    live = (pos > 0).to(torch.int32)
                    lg, pools = lm_decode_paged(p, tok, pos, (pos + 1) * live,
                                                pools, pt, cfg)
                    out.append(lg)
                    pos = pos + live
                logits[devname] = torch.stack(out).cpu()
            live_rows = torch.from_numpy(lens > 0)
            err, ok = close(logits["cuda"][:, live_rows],
                            logits["cpu"][:, live_rows], 1e-4)
            assert ok, f"parity {arch}/{backend}: max abs err {err}"
            assert torch.isfinite(logits["cuda"]).all()
            log(f"parity {arch} smoke/{backend}: card vs CPU logits max abs "
                f"err {err:.3g} (tol 1e-4)")


# ---------------------------------------------------------------------------
# phase 5: the slice at full width


def profile_run(eng, vocab, lens):
    """A second, profiled run on the same engine (8 requests, 8 new
    tokens each): device-busy share of the wall time and the kernels that
    take the device time.  Kept apart from the timed run, whose numbers
    the profiler would distort."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request, SamplingParams

    rng = np.random.default_rng(SEED + 1)
    reqs = [Request(prompt=[int(t) for t in rng.integers(0, vocab, n)],
                    sampling=SamplingParams(max_new=8), rid=100 + i)
            for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    ticks0 = eng.ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in eng.stream(*reqs):
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    return dict(
        wall_s=wall, ticks=eng.ticks - ticks0,
        device_busy_s=busy if busy > 0 else "not measured",
        device_idle_share=1 - busy / wall if busy > 0 else "not measured",
        top_kernels_ms=[(name[:70], us / 1e3)
                        for name, us in by_name.most_common(6)])


def slice_phase():
    from repro_torch.configs import get_config
    from repro_torch.kernels import bacam_decode as bdec
    from repro_torch.kernels import paged_flash_decode as pfd
    from repro_torch.models import count_params, init_params
    from repro_torch.serving import Request, SamplingParams, ServeEngine

    launches = {}
    results = {}
    for backend in ("camformer", "dense"):
        cfg = get_config("camformer-bert", attn_backend=backend)
        params = init_params(cfg, device="cuda", seed=SEED)
        n_params = count_params(params)
        eng = ServeEngine(cfg, params, max_batch=8, max_len=1024,
                          page_size=64, mode="overlap", device="cuda")
        del params
        rng = np.random.default_rng(SEED)
        lens = SLICE_LENS
        reqs = [Request(prompt=[int(t) for t in
                                rng.integers(0, cfg.vocab, n)],
                        sampling=SamplingParams(max_new=32), rid=i)
                for i, n in enumerate(lens)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bdec.launches = 0
        pfd.launches = 0
        pfd.prefill_launches = 0
        t0 = time.perf_counter()
        first = {}
        n_tok = 0
        for out in eng.stream(*reqs):
            first.setdefault(out.rid, time.perf_counter() - t0)
            n_tok += out.token is not None
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[backend] = dict(bacam=bdec.launches, flash=pfd.launches,
                                 flash_prefill=pfd.prefill_launches)
        assert eng.tick_errors == 0, f"{backend}: {eng.last_error}"
        for r in reqs:
            assert r.finish_reason == "length", (backend, r.rid,
                                                 r.finish_reason, r.error)
            assert len(r.tokens) == 32, (backend, r.rid, len(r.tokens))
            assert all(0 <= t < cfg.vocab for t in r.tokens), (backend, r.rid)
        assert eng.readbacks == eng.ticks + eng.prefill_ticks, (
            backend, eng.readbacks, eng.ticks, eng.prefill_ticks)
        ttft = sorted(first.values())
        results[backend] = dict(
            wall_s=wall, ticks=eng.ticks, ticks_per_s=eng.ticks / wall,
            tokens=n_tok, tokens_per_s=n_tok / wall,
            ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
            readbacks=eng.readbacks, host_blocked_s=eng.blocked_s,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            params=n_params, launches=launches[backend])
        log(f"slice camformer-bert/{backend}: {json.dumps(results[backend])}")
        log(f"profile camformer-bert/{backend}: "
            f"{json.dumps(profile_run(eng, cfg.vocab, lens))}")
        del eng
        torch.cuda.empty_cache()
    assert launches["camformer"]["bacam"] > 0, launches
    assert launches["dense"]["flash"] > 0, launches
    assert launches["dense"]["flash_prefill"] > 0, launches
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    took = build.build(build.SOURCES)
    log(f"build: {time.perf_counter() - t0:.1f}s wall "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in took.items())}) "
        f"into {build.BUILD_DIR}")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 256 MiB, five times the L2, overwritten before each timed launch
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    rows = kernel_phase(flush)
    del flush
    parity_phase()
    launches = slice_phase()
    by_name = {"bacam_paged_topk_stage1": launches["camformer"]["bacam"],
               "paged_flash_decode": launches["dense"]["flash"]
               - launches["dense"]["flash_prefill"],
               "paged_flash_decode (sq>1)":
               launches["dense"]["flash_prefill"]}
    for row in rows:
        row["launches"] = by_name[row["name"]]
        assert row["launches"] > 0, row
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if row[key] is not None:
                assert math.isfinite(row[key]), row
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
