"""Run the PyTorch/CUDA port's serving and training paths once on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, exits 0 only if all pass
    python3 chip_smoke.py --stage1-bounds   # the stage-1 fault check only

Phases, in order (each raises on failure; nothing is caught):

  1. the card's name and power limit (``nvidia-smi``);
  2. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, started together) into ``build/``;
  3. kernels: the launch floor (a one-element ``zero_()`` timed as the
     kernels are); at the shapes of the paths below, each kernel against its
     plain PyTorch version on the same inputs on the card (bit-exact for
     integer scores, CAM candidates and bit-sliced products; 1e-5 for the
     f32 flash rows, 2**-7 for bf16 contiguous flash), then CUDA-event
     times of kernel, plain version and one PyTorch library call; the
     bit-sliced VMM is also timed as the per-plane loop over the BA-CAM
     matrix kernel (its earlier design), for before and after in one run,
     the split-KV paged flash decode with 1 and 2 pages a split, and the
     stage-1 prefill chunk beside two fill_() of its candidate tensors;
     the stage-1 checks cover every index, fully masked groups (base + s),
     all-tie groups, stage1_k = group = 32 and GQA rows; the paged flash
     kernel is also checked and timed in its binary mode (the drafter's
     decode shape) and at a verify chunk of ``VERIFY_M`` rows;
  4. parity: small-width models on the card (kernel path) against the
     same models on the CPU (plain path): the paged forward, and the
     contiguous ``lm_prefill`` + 8 ``lm_decode`` steps; then, at the f32
     smoke width, keyed draws on the card against the CPU's, and
     speculative streams (sync and overlap) against plain decode at
     temperature 0.9; and a full-width draw at bf16 (``init_params(...,
     dtype=)``) against the float32 draw cast afterwards, bit for bit;
  5. paged slice: ``camformer-bert`` at full width in bf16 with seeded
     random weights, served by ``ServeEngine`` (8 slots, 1024 tokens,
     overlap mode; built as the serve launcher builds it) for 8 greedy
     requests on ``camformer``, ``dense``, ``binary`` and ``hybrid``,
     checking finish reasons, tick errors, one readback per tick, the
     peak memory below the card's, that each kernel of the path was
     launched, and on ``camformer`` and ``dense`` exact launch counts
     against the engine's ticks (phase 16 states them);
     then speculation (``spec_k = SPEC_K``, ``binary`` drafter) on
     ``dense`` and ``camformer`` at temperature 0.9, with exact launch
     counts, beside plain decode of the same requests (the share of equal
     tokens is printed, not asserted: at bf16 verify and sequential
     decode sum in different orders);
  6. contiguous slice: the same model with ``use_kernel`` through
     ``make_prefill_step`` / ``make_serve_step``, 8 prompts of 896 tokens
     in a 1024-token cache: (a) whole-prompt prefill and 127 greedy
     decode steps, (b) ``prefill_chunk=128`` (7 chunks) and 31 steps,
     checking each kernel's launch count and that no plain version ran
     on the card;
  7. the MoE and VLM families: ``granite-moe-3b-a800m`` at full width
     and depth in bf16 served like phase 5 on ``camformer`` and
     ``dense``; ``llava-next-mistral-7b`` at full width cut to 4 layers,
     f32, through the contiguous steps with 576 patch embeddings and 320
     text tokens (kernel 4 for the prefill, kernel 3 for 16 decode
     steps), held against its plain route on the card and on the CPU;
  8. training: at f32 smoke width the train step (remat, camformer with
     ``use_kernel``; camformer-bert and granite at G = 3) on the card
     against the card's plain route (BA-CAM scores identical, loss and
     gradients within 1e-6) and the CPU (loss 1e-5, gradients 1e-4);
     ``camformer-bert`` at full width and depth (f32 masters, bf16
     compute) through ``Trainer`` at 8 x 1024 tokens for 12 steps on
     ``camformer`` with ``use_kernel`` (kernel 4 exactly 2 x 24 x 12
     times: forward and recompute) and on ``dense``, every loss finite
     and the last below the first, checkpoints every 6 steps (under
     ``build/train_ckpt``, removed after) and a second ``Trainer``
     resuming from the last (granite's MoE backward at full depth is
     phase 17's); the flow of ``examples/had_distill.py`` at its own
     width;
  9. the gateway: ``camformer-bert`` as in phase 5 behind
     ``serve_background`` (HTTP/SSE over local sockets, the engine on
     the runner thread) on ``camformer`` and ``dense``: (a) a greedy and
     a keyed request whose SSE streams equal a second fresh engine's
     in-process ``stream()`` token for token; (b) 8 clients 50 ms apart
     (phase 5's prompts, 32 new tokens), every request ending on
     ``length``, no tick error, one readback a tick, the pool balanced,
     more than one prefill tick, exact launch counts (kernel 1 = 24 x
     decode ticks; kernel 2 = 24 x decode ticks and 2b = 24 x prefill
     ticks on ``dense``) and no plain version on the card; then the
     endpoints, and tokens/s, TTFT and TPOT beside the same requests
     served in process on this thread; (c) on ``dense``, a
     ``gateway.disconnect`` storm dropping 2 of 6 streams, cancelled
     and freed, and a fresh request after it.  The main thread does
     HTTP only while a runner thread drives the card;
 10. the encoder-decoder and Griffin families: at f32 smoke width,
     ``whisper-medium`` and ``recurrentgemma-2b`` (8 layers, window 16:
     the ring wraps) on ``dense`` and ``camformer`` + ``use_kernel``,
     card against CPU (prefill + 8 steps, logits within 1e-4, picks
     equal; a train step's loss 1e-5, gradients 1e-4); then at full
     width and depth in bf16 through the contiguous steps on
     ``camformer`` + ``use_kernel`` and ``dense``: ``whisper-medium``
     with 4 x 1500 stub frames, 32-token prompts, a 448-token cache and
     64 greedy steps (kernel 4 exactly 24 x (3 + 64) times, 24 of them
     the encoder's, kernel 3 24 x 64), ``recurrentgemma-2b`` with 4 x
     2016 tokens, ``cache_len`` 2080 (a 2048-slot ring) and 64 steps that
     wrap it (kernel 4 exactly 8 times, kernel 3 never: the ring's
     decode takes the plain CAM search); no plain version on the card,
     finite logits; prefill s (whisper's encoder apart), decode
     tokens/s, peak GB (allocated and reserved, after ``gc.collect()``
     and ``empty_cache``, beside what was live at the run's start) and a
     profiled window are printed;
 11. the ``ssm`` family and the BA-CAM device model: (a) ``rwkv6-3b`` at
     f32 smoke width (two heads of 64), card against CPU, prefill + 8
     steps (logits and the carried shifts and WKV state within 1e-4,
     picks equal) and a train step (loss 1e-5, gradients 1e-4); (b)
     ``rwkv6-3b`` at full width and depth in bf16 (32 layers, d 2560,
     3.07 G parameters) through the contiguous steps, 4 x 512-token
     prompts and 64 greedy steps: no kernel launched, no plain version
     on the card, finite logits, and the decode steps' peak memory after
     64 steps no higher than after 8 (the state is O(1)); prefill s,
     decode tokens/s, peak GB and a profiled window are printed; (c) the
     device model at camformer-bert's head geometry (1 x 16 x 1024 x
     64, one tile), 6-bit ADC and 1.4% matchline noise under a fixed raw
     key, card against CPU: threefry bits identical, normals within 4
     ulp, ADC scores equal away from the ADC's rounding boundaries,
     ``attention`` in ``camformer`` mode within 1e-4 (with
     ``use_kernel``: no kernel launched); 7-bit scores at d 256 equal to
     the exact integer path; the top-32 recall of the noisy 6-bit scores
     against the exact ones printed (a reading, not a gate); then
     ``examples/torch_quickstart.py`` runs on the card in a subprocess
     and must exit 0;
 12. distribution at a world of one: a real NCCL process group of one
     process (a file rendezvous under ``build/``) and its (1, 1)
     ``("data", "model")`` mesh as the ambient mesh: (a)
     ``camformer-bert`` at full width and depth through
     ``Trainer(mesh=)`` (the sharded step: DTensor blocks, gathered
     bf16 parameters, gradients reduced to blocks, the global norm; the
     ``model``-axis split's code, strategy ``heads``, on whole blocks
     with identity collectives at model = 1) for 4 steps of phase 8's
     schedule and seeds, its losses within 1e-6 relative of phase 8's
     first 4, kernel 4 exactly 2 x 24 x 4 times, the split regions run
     on all 16 heads, 4096 MLP columns and the whole vocabulary, no
     plain version on the card, step time and peak GB printed beside
     phase 8's; (b) its step-4 checkpoint (written by process 0)
     restored through ``rescale_state`` onto the mesh, ``verify_rescale``
     true; (c) a B = 1 ``distributed_topk`` decode (512-token prompt, 8
     steps) equal to the flag-off decode bit for bit; (d)
     ``whisper-medium`` (2 + 2 layers), ``recurrentgemma-2b`` (one
     period; both on ``camformer`` with ``use_kernel``) and ``rwkv6-3b``
     (2 blocks) at full width, bf16, 2 steps each through the unsharded
     step and through the sharded one (the split's code at model = 1):
     the losses bit for bit equal, kernel 4 launched as often by both;
     the group is destroyed and the NCCL version printed;
 13. tensor-parallel serving's shares, in one process (NCCL refuses two
     processes on one device, and a run gets one card): one layer of
     ``camformer-bert`` (on ``camformer``, ``dense``, ``binary``,
     ``hybrid``) and of ``granite-moe-3b-a800m`` (G = 3; ``camformer``,
     ``dense``) at full width, served by a tp = 1 engine with phase 5's
     geometry; its recorded 384-row prefill chunk and last decode tick
     are re-run as each rank's ``tp_local_decode`` on its
     ``slice_pools`` slice, at tp 2 and 4 (and 8 for granite): the
     outputs concatenated in rank order equal the tp = 1 call's bit for
     bit, each written slice equals the tp = 1 pool's head slice (the
     trash page aside) and holds 1/tp of its bytes, kernels 1, 2 and 2b
     launch exactly tp times the tp = 1 call's, no plain version runs
     on the card; the per-rank pool bytes and the phase's seconds are
     printed;
 14. the ``model`` split's shares of a training block, in one process
     (share mode, ``partitioning.run_shares``: each rank's share in
     turn, the collectives exchanged in process; no collective across
     cards is measured): one full-width f32 block of ``whisper-medium``
     (an encoder layer feeding a decoder layer, 2 x 1500 frames, 64
     tokens) and ``recurrentgemma-2b`` (one period, 2 x 512) on
     ``camformer`` with ``use_kernel`` and on ``dense``, and of
     ``rwkv6-3b`` (one block, 2 x 256), forward and backward unsplit,
     then as the shares at model = 2 and 4: outputs within 1e-5 of max
     |out|, every gradient within 1e-4 (the split leaves' blocks, the
     summed partial leaves), every kernel-4 launch bit-exact against its
     plain version, exact kernel-4 launches (one an attention a rank),
     no plain version on the card; the binarized Q/K signs that flip
     against the unsplit run are counted and a share with a flip is run
     again on the unsplit run's projections;
 15. the sharded contiguous serving steps: (a) inside phase 12's NCCL
     group of one, phase 6 (a)'s run (8 x 896 tokens, whole-prompt
     prefill) through ``make_prefill_step(mesh=)`` /
     ``make_serve_step(mesh=)`` on the (1, 1) mesh, with DTensor blocks
     of the weights and caches, cut to ``SERVE_SPLIT_STEPS`` greedy
     steps: the prefill logits and every step's logits bit-identical to
     phase 6's, kernel 4 once a layer, kernel 3 once a layer a step; (b)
     every rank's share of the sharded steps in turn in one process
     (``launch.steps.serve_shares``), f32 full width, B = 2 x 512 and 8
     greedy steps: ``camformer-bert`` (2 layers, its heads split at
     model = 2 and 4) and ``recurrentgemma-2b`` (one period; ``qheads``
     at 2 and ``q_seq`` at 4, its ring's sequence split over ``model``)
     on ``camformer`` with ``use_kernel``, recurrentgemma also on
     ``dense``: every step's logits within 1e-5 of max |logits| of the
     unsplit run's, the picks identical, exact kernel-4 and kernel-3
     launches, every kernel-4 launch bit-exact against its plain
     version, the Q/K sign flips counted and held as in phase 14, no
     plain version on the card;
 16. the assigned decoder LMs at full width and depth, one engine at a
     time: ``codeqwen1.5-7b``, ``mistral-nemo-12b``,
     ``llava-next-mistral-7b`` (text-only, 32 layers),
     ``moonshot-v1-16b-a3b`` and ``yi-34b``, each on ``camformer`` and
     ``dense``, with seeded random weights drawn at bf16 leaf by leaf,
     in the engine that ``python -m repro_torch.launch.serve --arch
     <arch> --backend <backend> --max-batch 8 --max-len 1024`` builds
     (its flags through ``add_engine_args``, the engine through
     ``build_engine``): phase 5's checks, exact launch counts (camformer:
     kernel 1 once a layer a decode tick, no flash launch; dense: kernel
     2 once a layer a decode tick, kernel 2b once a layer a prefill
     tick), the peak allocated memory of the draw and of the run
     below the card's total, and each engine freed without the cycle
     collector (what stays allocated after ``del`` is printed, under
     0.25 GB; the same holds for every engine ``serve_run`` builds);
 17. four families trained at full width and depth, one at a time,
     through ``Trainer`` as ``python -m repro_torch.launch.train --arch
     <arch>`` drives it (``SyntheticLMData``, f32 masters, bf16
     compute, remat, seeded weights and data, warmup 2), each batch
     ``train_4k`` (256 x 4096) cut to what one card holds and printed
     as ``reduced``: ``whisper-medium`` (24 + 24 layers, 8 x (1500 stub
     frames + 448 tokens), 4 steps) on ``camformer`` with ``use_kernel``
     (kernel 4 exactly 2 x (24 + 2 x 24) times a step: forward and
     recompute of the encoder, the decoder's self- and cross-attention),
     then checkpointed at step 4 (under ``build/``, removed after) and
     resumed by a second ``Trainer`` for 2 steps, and on ``dense``;
     ``recurrentgemma-2b`` (26 layers, 8 of them attention, 2 x 2048, 3
     steps) on ``camformer`` with ``use_kernel`` (kernel 4 exactly 2 x 8
     a step) and ``dense``; ``rwkv6-3b`` (32 blocks, 4 x 512, 3 steps)
     and ``granite-moe-3b-a800m`` (32 layers, G = 3, 8 x 1024, 3 steps)
     on ``dense``: every step's metrics finite, the last loss below the
     first on whisper, no other kernel launched and no plain version on
     the card, the peak allocated memory below the card's total (beside
     the state's 16 B a parameter), what stays allocated after ``del``
     under 0.25 GB, granite's aux loss positive and its drop share
     printed; step s, tokens/s, losses, grad norms and a profiled
     step's device-idle share on ``train <arch> ...`` lines;
 18. the long-context shapes at full length: ``mistral-nemo-12b`` at
     full width and depth, its bf16 weights drawn once for three legs,
     each leg's cache freed before the next: (a) prefill_32k and
     decode_32k on ``dense`` in the engine ``python -m
     repro_torch.launch.serve --arch mistral-nemo-12b --backend dense
     --max-batch 2 --max-len 32768 --prefill-chunk 4096`` builds: 2
     seeded 32,704-token prompts prefilled in 8 chunks of 4,096 (kernel
     2b over up to 32,768 keys) and decoded to 64 new tokens (kernel 2,
     512 one-page splits), with ``serve_run``'s checks (kernel 2b once a
     layer a chunk) and TTFT, decode tokens/s and the pool's and the
     run's peak GB printed; (b) long_500k on camformer's paged pools
     (8,192 live pages and the trash page, filled from the seed: random
     packed keys, N(0, 1) values, a k_scale a kv head; the page table a
     seeded permutation), 8 decode steps from position 524,280 through
     ``lm_decode_paged`` on ``paged_impl="fused"`` (kernel 1 over 8,192
     pages a layer) and again from the same state on ``"gather"``; (c)
     long_500k on a contiguous cache of 524,288 positions through
     ``make_serve_step`` with ``use_kernel`` (kernel 3) and without: in
     (b) and (c) the two routes' stage-1 candidates identical at every
     step and layer (each layer's distinct scores and tied pairs
     printed at step 1), their greedy tokens identical and logits within
     1e-5 of max |logits|, exact launch counts, no plain version on the
     card, the cache written in place and the peak below the card's
     total.

Phase 3 also holds kernels 1, 2 and 2b at each geometry phase 16 serves
(head_dim 128, W = 4: G = 1 on 32 kv heads for codeqwen1.5-7b and on 16
for moonshot-v1-16b-a3b, G = 4 on 8 for mistral-nemo-12b and llava, G = 7
on 8 for yi-34b), each a ``kernels`` row whose launches are phase 16's
runs at that geometry.  It holds kernels 1, 2 (dense and binary) and
2b at granite's GQA width (8 kv heads, G = 3), and kernel 4 at the train
step's shape (128, 1024, 1024), at phase 10's five shapes
(recurrentgemma's prefill, W = 8; whisper's 1500-key encoder, decoder
prefill and cross-attention) and at llava's prefill (W = 4), bit-exact;
it holds kernel 4 at phase 17's train shapes (whisper's encoder
(128, 1500, 1500), decoder self-attention (128, 448, 448) and
cross-attention (128, 448, 1500), W = 2; recurrentgemma's attention
(2, 20480, 2048), W = 8), bit-exact; it times kernel 4's designs
(tensor cores with the s8 and the b1
product, popc) apart at one shape of each W on a path and at 1500 and
1504 keys, and logs them on a ``bacam_mvm designs`` line; phase 4 also
runs granite smoke at G = 3 card against CPU, and one full-width
granite ``apply_moe`` layer card against CPU (routing identical,
outputs within 1e-5); and kernels 1 and 3 over 524,288 keys (bit-exact
at the first and the last of phase 18's steps), kernel 2 over 2 slots of
32,768 keys and kernel 2b at phase 18's last 4,096-row prefill chunk
(within 1e-5), a row each whose launches are phase 18's
(``LONG_ROWS``).

The line before the last is the ``kernels`` JSON object (one row per
kernel and shape: the paged flash and contiguous stage-1 kernels have a
second ``(sq>1)`` row for their prefill chunks, the paged flash kernel
also a ``(binary)`` and a verify row, kernels 1, 2 and 2b a row each at
yi-34b's shapes, the BA-CAM matrix kernel a ``(train)`` row at the
train step's shape and a row at each of phase 10's five shapes, at
llava's, at a phase-14 share of whisper's encoder and at each of phase
17's four train shapes, kernels 1, 3, 2 and 2b a row each at phase
18's shapes; ``path`` names the runs that launch it); the
last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA card, or without the rest of the repository
next to this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import re
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
F32_FLOP_PER_S = 67e12  # non-tensor-core float32
BF16_TC_FLOP_PER_S = 989e12  # tensor cores, bf16 in, f32 accumulate
TF32_TC_FLOP_PER_S = 495e12  # tensor cores, TF32
INT8_TC_OP_PER_S = 1979e12  # tensor cores, int8 in, int32 accumulate
# The data sheet gives no rate for scalar integer work.  The f32 rate is
# an upper limit for it: xor and add issue at half the f32 FMA rate and
# popcount at an eighth (CUDA C++ Programming Guide, arithmetic
# instruction throughput), so an operation bound taken at this rate is a
# lower bound; the rows that use it are bytes-bound all the same.
INT32_OP_PER_S = F32_FLOP_PER_S

SEED = 0


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, *, n=30, warmup=3, flush=None):
    """Median CUDA-event time of fn() in ms; ``flush`` (a large buffer)
    is overwritten before every timed launch so L2 starts cold.  A 1 ms
    device spin before the start event keeps the card busy while the host
    enqueues fn's work, so a slow host (Python wrapper, shared cores)
    adds no idle gap to a microsecond kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)  # about 1 ms of cycles
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


def check_candidates(label, got, want, group, stage1_k):
    """Stage-1 candidates bit-exact: values everywhere, indices everywhere
    (on valid candidates, and the lowest masked indices the plain stable
    top-k picks), and base + s on every fully masked group (its first
    candidate is masked).  Returns the numbers of valid candidates and of
    fully masked groups."""
    from repro_torch.kernels.ref import MASKED_SCORE

    (got_v, got_i), (want_v, want_i) = got, want
    torch.cuda.synchronize()
    assert torch.equal(got_v, want_v), f"{label}: values differ"
    valid = want_v > MASKED_SCORE // 2
    assert torch.equal(got_i[valid], want_i[valid]), \
        f"{label}: indices differ on valid candidates"
    assert torch.equal(got_i, want_i), f"{label}: masked indices differ"
    v = got_v.reshape(*got_v.shape[:-1], -1, stage1_k)
    dead = v[..., 0] == MASKED_SCORE
    ar = torch.arange(v.shape[-2], dtype=torch.int32, device=v.device)
    base = (ar * group)[:, None] + torch.arange(
        stage1_k, dtype=torch.int32, device=v.device)
    assert torch.equal(got_i.reshape(v.shape)[dead],
                       base.expand_as(v)[dead]), \
        f"{label}: fully masked groups' indices are not base + s"
    return int(valid.sum()), int(dead.sum())


def launch_floor(flush):
    """The time one trivial launch takes under cuda_ms (a one-element
    zero_(), the L2 flushed before it): each kernel's time is this floor
    plus its work."""
    one = torch.empty(1, dtype=torch.int32, device="cuda")
    return cuda_ms(one.zero_, flush=flush)


# ---------------------------------------------------------------------------
# launch counts and plain-version calls


def kernel_modules():
    """{kernel wrapper module: the name of its plain version in it}."""
    from repro_torch.kernels import (bacam_decode, bacam_mvm, bacam_topk,
                                     bitslice_vmm, flash_attention,
                                     paged_flash_decode)

    return {bacam_decode: "bacam_paged_topk_ref",
            paged_flash_decode: "paged_flash_decode_ref",
            bacam_topk: "bacam_topk_stage1_plain",
            bacam_mvm: "bacam_scores_ref",
            bitslice_vmm: "bitslice_vmm_ref",
            flash_attention: "flash_attention_ref"}


def reset_launches():
    from repro_torch.kernels import paged_flash_decode

    from repro_torch.kernels import bacam_topk

    from repro_torch.kernels import bacam_mvm

    for mod in kernel_modules():
        mod.launches = 0
    bacam_mvm.shape_launches.clear()
    paged_flash_decode.prefill_launches = 0
    paged_flash_decode.binary_launches = 0
    paged_flash_decode.sq_launches.clear()
    bacam_topk.prefill_launches = 0


def read_launches(families=False):
    """Launches since the last reset, by the kernels line's row names;
    with ``families``, kernel 4's launches at the shapes of
    ``FAMILY_MVM_SHAPES`` (phases 7 and 10) apart, in rows of their own."""
    from repro_torch.kernels import (bacam_decode, bacam_mvm, bacam_topk,
                                     bitslice_vmm, flash_attention,
                                     paged_flash_decode)

    pfd = paged_flash_decode
    verify = pfd.sq_launches[VERIFY_M]
    at_shape = {name: bacam_mvm.shape_launches[shape] if families else 0
                for name, shape in FAMILY_MVM_SHAPES.items()}
    return {"bacam_paged_topk_stage1": bacam_decode.launches,
            "paged_flash_decode": pfd.launches - pfd.prefill_launches
            - pfd.binary_launches,
            "paged_flash_decode (binary)": pfd.binary_launches,
            "paged_flash_decode (sq>1)": pfd.prefill_launches - verify,
            f"paged_flash_decode (sq>1, verify m={VERIFY_M})": verify,
            "bacam_topk_stage1": bacam_topk.launches
            - bacam_topk.prefill_launches,
            "bacam_topk_stage1 (sq>1)": bacam_topk.prefill_launches,
            "bacam_mvm": bacam_mvm.launches - sum(at_shape.values()),
            **at_shape,
            "bitslice_vmm": bitslice_vmm.launches,
            # one wrapper and one count for the two flash kernels
            "flash_attention": flash_attention.launches,
            "flash_attention_f32": flash_attention.launches}


@contextlib.contextmanager
def plain_calls_on_card():
    """Count, by name, the calls of every kernel's plain version that get
    a CUDA tensor while the block runs (a path run must make none)."""
    calls = {}
    saved = {}
    for mod, name in kernel_modules().items():
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            if any(torch.is_tensor(x) and x.is_cuda for x in a):
                calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        saved[mod] = (name, fn)
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, (name, fn) in saved.items():
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions

# the slice phase's prompt lengths; its prefill tick runs them as one
# chunk of Sq = 384 rows at q_pos 0, and its decode ticks at lens + t
SLICE_LENS = [64, 96, 128, 192, 256, 320, 352, 384]
MID_DECODE = 16  # decode step whose kv_len the decode kernels are timed at
SPEC_K = 3  # the speculation phase's drafts per tick
VERIFY_M = SPEC_K + 1  # a verify chunk's rows per slot (G = 1)


def kernel_phase(flush):
    from repro_torch.core.bacam import pack_bits
    from repro_torch.kernels import bacam_decode as bdec
    from repro_torch.kernels import paged_flash_decode as pfd

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    lens = torch.tensor(SLICE_LENS, dtype=torch.int32)
    ragged = torch.tensor([1024, 700, 513, 64, 1, 0, 300, 0],
                          dtype=torch.int32)
    decode_len = lens + MID_DECODE

    # --- bacam stage-1 at the decode shapes: 8 slots, 16 kv heads, R = 1,
    # W = 2 (d = 64), 64-key pages, 16 pages (1024 tokens).  Checked on
    # ragged + inert slots (table entries past kv_len on the trash page)
    # with each option, GQA rows (R = G = 8) with a window, all-tie groups
    # (one key word per group) and stage1_k = group = 32, then at the
    # slice's mid-decode kv_len, which is also the timed case.
    b, hkv, d, page, np_ = 8, 16, 64, 64, 16
    default = dict(group=16, stage1_k=2, window=None)
    cases = [(ragged, default, 1, False),
             (ragged, dict(group=16, stage1_k=2, window=100), 1, False),
             (ragged, dict(group=4, stage1_k=3, window=None), 1, False),
             (ragged, dict(group=16, stage1_k=2, window=100), 8, False),
             (ragged, default, 1, True),
             (ragged, dict(group=32, stage1_k=32, window=None), 1, False),
             (decode_len, default, 1, False)]
    for kv_len, kw, r, ties in cases:
        kp, table = ragged_pool(gen, b, hkv, page, np_, kv_len,
                                torch.float32, d)
        kp = pack_bits(kp)
        if ties:  # every key of a group carries its first key's words
            kp = kp[:, :, ::kw["group"]].repeat_interleave(kw["group"], 2)
        q = pack_bits(torch.randn((b, hkv, r, d), generator=gen))
        q_pos = torch.clamp(kv_len - 1, min=0)
        args = [t.to(dev).contiguous() for t in (q, kp, table, kv_len, q_pos)]
        got = bdec.bacam_paged_topk_stage1(*args, d=d, **kw)
        want = bdec.bacam_paged_topk_ref(
            args[0], args[1], args[2], args[3], d, q_pos=args[4],
            group_size=kw["group"], stage1_k=kw["stage1_k"],
            window=kw["window"])
        n_valid, n_dead = check_candidates(
            f"bacam_paged_topk_stage1 {kw} R={r} ties={ties}", got, want,
            kw["group"], kw["stage1_k"])
        log(f"bacam_paged_topk_stage1 kv_len {kv_len.tolist()} {kw} R={r}"
            f"{' all ties' if ties else ''}: bit-exact ({n_valid} valid "
            f"candidates, {n_dead} fully masked groups at base + s)")
    # args, q, kv_len, q_pos are now the mid-decode case
    kern = lambda: bdec.bacam_paged_topk_stage1(*args, d=d)
    plain = lambda: bdec.bacam_paged_topk_ref(
        args[0], args[1], args[2], args[3], d, q_pos=args[4])
    keys = causal_keys(kv_len, q_pos, 1)
    ncand = 2 * (page // 16) * np_
    bytes_ = (q.numel() * 4 + keys * hkv * (d // 32) * 4
              + table.numel() * 4 + 2 * b * 4 + 2 * b * hkv * ncand * 4)
    ops = 3 * keys * hkv * (d // 32)  # xor, popc, add per word
    ms = cuda_ms(kern, flush=flush)
    rows.append(dict(
        name="bacam_paged_topk_stage1", route="cuda", path="paged, gateway",
        source="src/repro_torch/csrc/bacam_decode.cu",
        replaces="src/repro/kernels/bacam_decode.py:137",
        max_abs_err=0.0, ms=ms, plain_ms=cuda_ms(plain, flush=flush),
        **bound(bytes_, ops / INT32_OP_PER_S), library_ms=None))
    log(f"bacam_paged_topk_stage1 (decode): kernel {ms:.6g} ms"
        f", plain {rows[-1]['plain_ms']:.6g} ms, bound "
        f"{rows[-1]['bound_ms']:.6g} ms by {rows[-1]['bound_by']}")

    # --- paged flash attention on bf16 pools.  The two cases with a name
    # are the slice's own (mid-decode, and its one prefill chunk: 384
    # rows at q_pos 0, padding rows past each prompt) and are timed; the
    # others are checked only (ragged + inert slots, nonzero offsets).
    offsets = torch.tensor([0, 256, 384, 0, 128, 0, 640, 0],
                           dtype=torch.int32)
    live = torch.tensor([1, 1, 1, 1, 1, 0, 1, 0], dtype=torch.int32)
    # The binary row is the speculation phase's drafter step (and binary
    # serving): sign(q) rows times the score scale and a per-row
    # temperature, keys binarized in the kernel.  The verify row is a
    # dense target's verify chunk of VERIFY_M rows a slot at mid-decode.
    verify_len = decode_len + VERIFY_M
    flash_cases = [
        (None, 1, ragged, torch.clamp(ragged - 1, min=0), False),
        (None, 128, (offsets + 128) * live, offsets, False),
        (None, VERIFY_M, ragged, torch.clamp(ragged - VERIFY_M, min=0),
         True),
        ("paged_flash_decode", 1, decode_len, decode_len - 1, False),
        ("paged_flash_decode (binary)", 1, decode_len, decode_len - 1, True),
        ("paged_flash_decode (sq>1)", 384, lens, torch.zeros_like(lens),
         False),
        (f"paged_flash_decode (sq>1, verify m={VERIFY_M})", VERIFY_M,
         verify_len, verify_len - VERIFY_M, False),
    ]
    for name, sq, kv_len, q_pos, binary in flash_cases:
        kpool, table = ragged_pool(gen, b, hkv, page, np_, kv_len,
                                   torch.bfloat16, d)
        vpool, _ = ragged_pool(gen, b, hkv, page, np_, kv_len,
                               torch.bfloat16, d)
        qr = torch.randn((b, hkv, sq, d), generator=gen) * d**-0.5
        if binary:  # sign(q) / sqrt(d) times a temperature per row
            temp = 0.5 + torch.rand((b, hkv, sq, 1), generator=gen)
            qr = torch.where(qr > 0, 1.0, -1.0) * d**-0.5 * temp
        a = [t.to(dev).contiguous()
             for t in (qr, kpool, vpool, table, kv_len, q_pos)]
        kw = dict(sq=sq, binary=binary)
        got = pfd.paged_flash_decode(*a, **kw)
        want = pfd.paged_flash_decode_ref(*a, **kw)
        err, ok = close(got, want, 1e-5)
        label = (f"paged_flash_decode sq={sq}{' binary' if binary else ''} "
                 f"kv_len {kv_len.tolist()}")
        assert ok, f"{label} bf16 pools: max abs err {err}"
        inert = (kv_len == 0).to(dev)
        assert torch.all(got[inert] == 0), f"{label}: inert rows not zero"
        log(f"{label} bf16 pools: max abs err {err:.3g} (tol 1e-5 rel+abs)")
        if name is None:
            continue
        kern = lambda: pfd.paged_flash_decode(*a, **kw)
        plain = lambda: pfd.paged_flash_decode_ref(*a, **kw)
        library = library_attention(a, sq, binary)
        keys = sum(int(n) for n in kv_len)
        bytes_ = (qr.numel() * 4 + 2 * keys * hkv * d * 2
                  + table.numel() * 4 + 2 * b * 4 + got.numel() * 4)
        # QK^T and PV, 2 FLOPs per multiply-add, over causal (row, key)
        flops = 2 * 2 * causal_keys(kv_len, q_pos, sq) * hkv * d
        design, _ = pfd.plan(b, hkv, sq, d, d, page, np_, sq, True)
        if pfd.DESIGNS[design] != "chunk tiles":  # f32 FMA, CUDA cores
            op_s = flops / F32_FLOP_PER_S
            log(f"{name}: design {pfd.DESIGNS[design]}")
        if name == "paged_flash_decode":
            for pages in (1, 2):  # pages per split, 1 (the wrapper's) vs 2
                run = lambda: pfd.launch(*a, sq=sq, split_pages=pages)
                err_sp, ok = close(run(), want, 1e-5)
                assert ok, f"{name} {pages} pages a split: max abs err {err_sp}"
                log(f"{name}: split-KV, {pages} page(s) of {page} keys a "
                    f"split, {-(-np_ // pages)} splits, kernel "
                    f"{cuda_ms(run, flush=flush):.6g} ms")
            log(f"{name}: timed below with 1 page a split, "
                f"{np_} splits of grid")
        elif pfd.DESIGNS[design] == "chunk tiles":
            # QK^T in f32 FMA, PV in three bf16 parts on the tensor cores:
            # separate units, so the larger of the two times
            op_s = max(flops / 2 / F32_FLOP_PER_S,
                       3 * flops / 2 / BF16_TC_FLOP_PER_S)
            log(f"{name}: design {pfd.DESIGNS[design]} (P V on the tensor"
                f" cores), operations {op_s * 1e3:.6g} ms (QK^T "
                f"{flops / 2e9:.4g} GFLOP f32, PV 3 x {flops / 2e9:.4g} "
                f"GFLOP bf16); all in f32 FMA it was "
                f"{flops / F32_FLOP_PER_S * 1e3:.6g} ms")
        rows.append(dict(
            name=name, route="cuda",
            path=("binary+spec" if binary else
                  "spec" if sq == VERIFY_M else "paged, gateway"),
            source="src/repro_torch/csrc/paged_flash_decode.cu",
            replaces="src/repro/kernels/paged_flash_decode.py:228",
            max_abs_err=err, ms=cuda_ms(kern, flush=flush),
            plain_ms=cuda_ms(plain, flush=flush), **bound(bytes_, op_s),
            library_ms=cuda_ms(library, flush=flush)))
        log(f"{name}: kernel {rows[-1]['ms']:.6g} ms, SDPA "
            f"{rows[-1]['library_ms']:.6g} ms, bound "
            f"{rows[-1]['bound_ms']:.6g} ms by {rows[-1]['bound_by']}")

    # --- split-KV edges on bf16 pools, checked only: 16-key pages (up to
    # 63 splits), kv_len one key into a page, a window across split
    # boundaries, and G = 8 rows per kv head
    edges = [(1, 16, 64, torch.tensor([1000, 17, 0, 1, 64, 65, 999, 512],
                                      dtype=torch.int32), None),
             (1, 16, 64, torch.tensor([1000, 17, 0, 1, 64, 65, 999, 512],
                                      dtype=torch.int32), 40),
             (8, 64, 16, ragged, None), (8, 64, 16, ragged, 100)]
    for g, epage, enp, kv_len, window in edges:
        ehkv = 4 if g > 1 else hkv
        kpool, table = ragged_pool(gen, b, ehkv, epage, enp, kv_len,
                                   torch.bfloat16, d)
        vpool, _ = ragged_pool(gen, b, ehkv, epage, enp, kv_len,
                               torch.bfloat16, d)
        qr = torch.randn((b, ehkv, g, d), generator=gen) * d**-0.5
        q_pos = torch.clamp(kv_len - 1, min=0)
        a = [t.to(dev).contiguous()
             for t in (qr, kpool, vpool, table, kv_len, q_pos)]
        got = pfd.paged_flash_decode(*a, window=window)
        want = pfd.paged_flash_decode_ref(*a, window=window)
        err, ok = close(got, want, 1e-5)
        label = (f"paged_flash_decode split-KV G={g} page {epage} x {enp} "
                 f"window {window} kv_len {kv_len.tolist()}")
        assert ok, f"{label}: max abs err {err}"
        assert torch.all(got[(kv_len == 0).to(dev)] == 0), f"{label}: inert"
        log(f"{label}: max abs err {err:.3g} (tol 1e-5 rel+abs)")

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


# granite-moe-3b-a800m's attention: 24 heads on 8 kv heads, head_dim 64
GQA3_HKV, GQA3_G = 8, 3


def gqa3_kernel_phase():
    """Kernels 1, 2 (and its binary mode) and 2b against their plain
    versions at granite's GQA width (8 kv heads, G = 3 rows a kv head,
    head_dim 64) on the slice's pools (8 slots, 64-token pages x 16):
    decode rows at the mid-decode kv_len and at ragged + inert kv_len,
    and the 384-row prefill chunk (R = 3 x 384, row r at q_pos + r % 384).
    Returns {case: max abs err} (0 for the bit-exact stage-1 checks)."""
    from repro_torch.core.bacam import pack_bits
    from repro_torch.kernels import bacam_decode as bdec
    from repro_torch.kernels import paged_flash_decode as pfd

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 3)
    b, hkv, g, d, page, np_ = 8, GQA3_HKV, GQA3_G, 64, 64, 16
    lens = torch.tensor(SLICE_LENS, dtype=torch.int32)
    ragged = torch.tensor([1024, 700, 513, 64, 1, 0, 300, 0],
                          dtype=torch.int32)
    errs = {}
    for label, kv_len in (("mid-decode", lens + MID_DECODE),
                          ("ragged", ragged)):
        q_pos = torch.clamp(kv_len - 1, min=0)
        kp, table = ragged_pool(gen, b, hkv, page, np_, kv_len,
                                torch.float32, d)
        q = pack_bits(torch.randn((b, hkv, g, d), generator=gen))
        a = [t.to(dev).contiguous()
             for t in (q, pack_bits(kp), table, kv_len, q_pos)]
        got = bdec.bacam_paged_topk_stage1(*a, d=d)
        want = bdec.bacam_paged_topk_ref(a[0], a[1], a[2], a[3], d,
                                         q_pos=a[4])
        n_valid, n_dead = check_candidates(
            f"bacam_paged_topk_stage1 G=3 {label}", got, want, 16, 2)
        errs[f"bacam_paged_topk_stage1 G=3 {label}"] = 0.0
        log(f"bacam_paged_topk_stage1 G=3 (R = 3 rows on {hkv} kv heads) "
            f"{label} kv_len {kv_len.tolist()}: bit-exact ({n_valid} valid "
            f"candidates, {n_dead} fully masked groups at base + s)")
        for binary in (False, True):
            kpool, table = ragged_pool(gen, b, hkv, page, np_, kv_len,
                                       torch.bfloat16, d)
            vpool, _ = ragged_pool(gen, b, hkv, page, np_, kv_len,
                                   torch.bfloat16, d)
            qr = torch.randn((b, hkv, g, d), generator=gen) * d**-0.5
            if binary:
                qr = torch.where(qr > 0, 1.0, -1.0) * d**-0.5
            a = [t.to(dev).contiguous()
                 for t in (qr, kpool, vpool, table, kv_len, q_pos)]
            got = pfd.paged_flash_decode(*a, binary=binary)
            want = pfd.paged_flash_decode_ref(*a, binary=binary)
            name = (f"paged_flash_decode G=3{' binary' if binary else ''} "
                    f"{label}")
            err, ok = close(got, want, 1e-5)
            assert ok, f"{name}: max abs err {err}"
            assert torch.all(got[(kv_len == 0).to(dev)] == 0), name
            errs[name] = err
            log(f"{name} kv_len {kv_len.tolist()}: max abs err {err:.3g} "
                f"(tol 1e-5 rel+abs)")
    # the prefill chunk: 384 rows a slot at q_pos 0, G = 3 rows folded
    sq = max(SLICE_LENS)
    kpool, table = ragged_pool(gen, b, hkv, page, np_, lens, torch.bfloat16,
                               d)
    vpool, _ = ragged_pool(gen, b, hkv, page, np_, lens, torch.bfloat16, d)
    qr = torch.randn((b, hkv, g * sq, d), generator=gen) * d**-0.5
    a = [t.to(dev).contiguous() for t in (qr, kpool, vpool, table, lens,
                                          torch.zeros_like(lens))]
    got = pfd.paged_flash_decode(*a, sq=sq)
    want = pfd.paged_flash_decode_ref(*a, sq=sq)
    err, ok = close(got, want, 1e-5)
    design, _ = pfd.plan(b, hkv, g * sq, d, d, page, np_, sq, True)
    assert ok, f"paged_flash_decode (sq>1) G=3: max abs err {err}"
    errs["paged_flash_decode (sq>1) G=3"] = err
    log(f"paged_flash_decode (sq>1) G=3, {g} x {sq} rows a kv head, design "
        f"{pfd.DESIGNS[design]}: max abs err {err:.3g} (tol 1e-5 rel+abs)")
    torch.cuda.synchronize()
    return errs


def assigned_geometries():
    """{(kv heads, G query rows a kv head): the archs of phase 16 served at
    it}, read off their configs; every one has head_dim 128 (W = 4
    packed key words) and is served at phase 5's pool geometry."""
    from repro_torch.configs import get_config

    geoms = {}
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        assert cfg.head_dim == ASSIGNED_D, (arch, cfg.head_dim)
        g = cfg.n_heads // cfg.n_kv_heads
        geoms.setdefault((cfg.n_kv_heads, g), []).append(arch)
    return geoms


def geometry_row(kernel, hkv, g):
    """The ``kernels`` row of ``kernel`` at one of phase 16's geometries."""
    return f"{kernel} [G={g} H_kv={hkv} D={ASSIGNED_D}]"


def assigned_kernel_phase(flush):
    """Kernels 1, 2 and 2b at each geometry phase 16 serves
    (``assigned_geometries``: G = 1 on 32 and on 16 kv heads, G = 4 and
    G = 7 on 8, d = 128, W = 4) on phase 5's pools (8 slots, 64-key
    pages x 16): the decode step at the mid-decode kv_len (and, checked
    only, ragged + inert kv_len), and the 384-token prefill chunk (R = G x
    384 rows, row r at q_pos + r % 384).  Kernel 1 bit-exact, kernels 2
    and 2b within 1e-5; each then timed beside its plain version (and
    SDPA on gathered K/V for 2 and 2b), with its bound, as a row of its
    own whose launches are phase 16's at that geometry."""
    rows = []
    for (hkv, g), archs in assigned_geometries().items():
        rows += geometry_kernel_rows(flush, hkv, g, ", ".join(archs))
    torch.cuda.synchronize()
    return rows


def geometry_kernel_rows(flush, hkv, g, archs):
    from repro_torch.core.bacam import pack_bits
    from repro_torch.kernels import bacam_decode as bdec
    from repro_torch.kernels import paged_flash_decode as pfd

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 16 + 64 * hkv + g)
    b, d, page, np_ = 8, ASSIGNED_D, 64, 16
    w = d // 32
    shape = f"G={g} on {hkv} kv heads, W = {w}"
    lens = torch.tensor(SLICE_LENS, dtype=torch.int32)
    ragged = torch.tensor([1024, 700, 513, 64, 1, 0, 300, 0],
                          dtype=torch.int32)
    decode_len = lens + MID_DECODE
    rows = []
    for label, kv_len in (("ragged", ragged), ("mid-decode", decode_len)):
        q_pos = torch.clamp(kv_len - 1, min=0)
        kp, table = ragged_pool(gen, b, hkv, page, np_, kv_len,
                                torch.float32, d)
        q = pack_bits(torch.randn((b, hkv, g, d), generator=gen))
        a = [t.to(dev).contiguous()
             for t in (q, pack_bits(kp), table, kv_len, q_pos)]
        got = bdec.bacam_paged_topk_stage1(*a, d=d)
        want = bdec.bacam_paged_topk_ref(a[0], a[1], a[2], a[3], d,
                                         q_pos=a[4])
        n_valid, n_dead = check_candidates(
            f"bacam_paged_topk_stage1 {shape} {label}", got, want, 16, 2)
        log(f"bacam_paged_topk_stage1 {shape} {label} kv_len "
            f"{kv_len.tolist()}: bit-exact ({n_valid} valid candidates, "
            f"{n_dead} fully masked groups at base + s)")
    keys = causal_keys(kv_len, q_pos, 1)
    ncand = 2 * (page // 16) * np_
    # each input read once (q, the live keys' words, the table, kv_len and
    # q_pos), both outputs written once; xor, popc and add a word a row
    bytes_ = (q.numel() * 4 + keys * hkv * w * 4 + table.numel() * 4
              + 2 * b * 4 + 2 * b * hkv * g * ncand * 4)
    ops = 3 * keys * hkv * w * g
    ms = cuda_ms(lambda: bdec.bacam_paged_topk_stage1(*a, d=d), flush=flush)
    rows.append(dict(
        name=geometry_row("bacam_paged_topk_stage1", hkv, g), route="cuda",
        path=f"phase 16: {archs} camformer decode",
        source="src/repro_torch/csrc/bacam_decode.cu",
        replaces="src/repro/kernels/bacam_decode.py:137",
        max_abs_err=0.0, ms=ms,
        plain_ms=cuda_ms(lambda: bdec.bacam_paged_topk_ref(
            a[0], a[1], a[2], a[3], d, q_pos=a[4]), flush=flush),
        **bound(bytes_, ops / INT32_OP_PER_S), library_ms=None))
    log(f"{rows[-1]['name']}: kernel {ms:.6g} ms, plain "
        f"{rows[-1]['plain_ms']:.6g} ms, bound {rows[-1]['bound_ms']:.6g} ms "
        f"by {rows[-1]['bound_by']}")

    sq_chunk = max(SLICE_LENS)
    flash_cases = [(None, 1, ragged, torch.clamp(ragged - 1, min=0)),
                   ("paged_flash_decode", 1, decode_len, decode_len - 1),
                   ("paged_flash_decode (sq>1)", sq_chunk, lens,
                    torch.zeros_like(lens))]
    for kernel, sq, kv_len, q_pos in flash_cases:
        kpool, table = ragged_pool(gen, b, hkv, page, np_, kv_len,
                                   torch.bfloat16, d)
        vpool, _ = ragged_pool(gen, b, hkv, page, np_, kv_len,
                               torch.bfloat16, d)
        qr = torch.randn((b, hkv, g * sq, d), generator=gen) * d**-0.5
        a = [t.to(dev).contiguous()
             for t in (qr, kpool, vpool, table, kv_len, q_pos)]
        got = pfd.paged_flash_decode(*a, sq=sq)
        want = pfd.paged_flash_decode_ref(*a, sq=sq)
        err, ok = close(got, want, 1e-5)
        design, _ = pfd.plan(b, hkv, g * sq, d, d, page, np_, sq, True)
        label = (f"paged_flash_decode G={g} on {hkv} kv heads D={d} "
                 f"sq={sq} ({g * sq} rows a kv head, design "
                 f"{pfd.DESIGNS[design]}) kv_len {kv_len.tolist()}")
        assert ok, f"{label}: max abs err {err}"
        assert torch.all(got[(kv_len == 0).to(dev)] == 0), f"{label}: inert"
        log(f"{label}: max abs err {err:.3g} (tol 1e-5 rel+abs)")
        if kernel is None:
            continue
        keys = sum(int(n) for n in kv_len)
        bytes_ = (qr.numel() * 4 + 2 * keys * hkv * d * 2
                  + table.numel() * 4 + 2 * b * 4 + got.numel() * 4)
        # QK^T and PV, 2 FLOPs a multiply-add, over causal (row, key)
        # pairs of each of the G rows
        flops = 2 * 2 * causal_keys(kv_len, q_pos, sq) * hkv * d * g
        if pfd.DESIGNS[design] == "chunk tiles":
            # QK^T in f32 FMA, PV in three bf16 parts on the tensor cores
            op_s = max(flops / 2 / F32_FLOP_PER_S,
                       3 * flops / 2 / BF16_TC_FLOP_PER_S)
        else:
            op_s = flops / F32_FLOP_PER_S
        rows.append(dict(
            name=geometry_row(kernel, hkv, g), route="cuda",
            path=(f"phase 16: {archs} dense "
                  f"{'prefill' if sq > 1 else 'decode'}"),
            source="src/repro_torch/csrc/paged_flash_decode.cu",
            replaces="src/repro/kernels/paged_flash_decode.py:228",
            max_abs_err=err,
            ms=cuda_ms(lambda: pfd.paged_flash_decode(*a, sq=sq),
                       flush=flush),
            plain_ms=cuda_ms(lambda: pfd.paged_flash_decode_ref(*a, sq=sq),
                             flush=flush),
            **bound(bytes_, op_s),
            library_ms=cuda_ms(library_attention(a, sq), flush=flush)))
        log(f"{rows[-1]['name']}: design {pfd.DESIGNS[design]}, kernel "
            f"{rows[-1]['ms']:.6g} ms, plain {rows[-1]['plain_ms']:.6g} ms, "
            f"SDPA {rows[-1]['library_ms']:.6g} ms, bound "
            f"{rows[-1]['bound_ms']:.6g} ms by {rows[-1]['bound_by']}")
    return rows


# the long-context shapes (configs/base.SHAPES) on
# mistral-nemo-12b (8 kv heads, G = 4, head_dim 128, W = 4): phase 18
LONG_ARCH = "mistral-nemo-12b"
LONG_HKV, LONG_G, LONG_D = 8, 4, 128
LONG_PAGE = 64
# prefill_32k / decode_32k: 2 slots of 32,768 tokens, prompts of 32,704
# in chunks of 4,096, then 64 new tokens (the last reaches 32,768)
LONG_SLOTS, LONG_LEN, LONG_CHUNK, LONG_NEW = 2, 32768, 4096, 64
LONG_PROMPT = LONG_LEN - LONG_NEW
# long_500k: one slot decoding 8 steps from 524,280 written positions
LONG_KEYS, LONG_STEPS = 524288, 8
LONG_FILLED = LONG_KEYS - LONG_STEPS
LONG_ROWS = {  # phase 18's kernel-row names, by the launch counts' names
    "bacam_paged_topk_stage1": "bacam_paged_topk_stage1 [long_500k paged]",
    "bacam_topk_stage1": "bacam_topk_stage1 [long_500k contiguous]",
    "paged_flash_decode": "paged_flash_decode [decode_32k]",
    "paged_flash_decode (sq>1)": "paged_flash_decode (sq>1) [prefill_32k]"}


def long_words(gen, *shape):
    """Random packed-key words over the whole int32 range, on the card."""
    return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                         device="cuda", dtype=torch.int32)


def long_kernel_phase(flush):
    """Kernels 1, 3, 2 and 2b at phase 18's shapes, each against its plain
    version and timed, a row each whose launches are phase 18's:
    kernel 1 over one slot's 8,192 pages (524,288 keys, a permutation of
    the pool's pages, G = 4 on 8 kv heads, W = 4), kernel 3 over 8
    matrices of G = 4 rows and 524,288 keys, both at the first and the
    last decode step's kv_len (bit-exact; the last timed); kernel 2 over
    2 slots at kv_len 32,768 and kernel 2b at the last 4,096-token chunk
    of two 32,704-token prompts (q_pos 28,672; within 1e-5)."""
    from repro_torch.kernels import bacam_decode as bdec
    from repro_torch.kernels import bacam_topk as btk
    from repro_torch.kernels import paged_flash_decode as pfd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    hkv, g, d = LONG_HKV, LONG_G, LONG_D
    w = d // 32
    rows = []
    i32 = dict(dtype=torch.int32, device=dev)

    # --- kernel 1: the paged long_500k decode step
    n_live = LONG_KEYS // LONG_PAGE
    kp = long_words(gen, 1 + n_live, hkv, LONG_PAGE, w)
    table = (torch.randperm(n_live, generator=gen, device=dev) + 1).to(
        torch.int32)[None]
    q = long_words(gen, 1, hkv, g, w)
    for kv in (LONG_FILLED + 1, LONG_KEYS):
        kv_len = torch.tensor([kv], **i32)
        a = (q, kp, table, kv_len, kv_len - 1)
        got = bdec.bacam_paged_topk_stage1(*a, d=d)
        want = bdec.bacam_paged_topk_ref(*a[:4], d, q_pos=a[4])
        n_valid, n_dead = check_candidates(
            f"bacam_paged_topk_stage1 long_500k kv_len {kv}", got, want, 16,
            2)
        log(f"bacam_paged_topk_stage1 long_500k (1 slot, {n_live} pages, "
            f"G={g} on {hkv} kv heads, W={w}) kv_len {kv}: bit-exact "
            f"({n_valid} valid candidates, {n_dead} fully masked groups, "
            f"{got[0].unique().numel()} distinct scores)")
    bytes_ = (q.numel() * 4 + LONG_KEYS * hkv * w * 4 + table.numel() * 4
              + 2 * 4 + 2 * got[0].numel() * 4)
    rows.append(dict(
        name=LONG_ROWS["bacam_paged_topk_stage1"], route="cuda",
        path="phase 18 (b): mistral-nemo-12b camformer long_500k paged "
             "decode",
        source="src/repro_torch/csrc/bacam_decode.cu",
        replaces="src/repro/kernels/bacam_decode.py:137", max_abs_err=0.0,
        ms=cuda_ms(lambda: bdec.bacam_paged_topk_stage1(*a, d=d),
                   flush=flush),
        plain_ms=cuda_ms(lambda: bdec.bacam_paged_topk_ref(
            *a[:4], d, q_pos=a[4]), flush=flush),
        **bound(bytes_, 3 * LONG_KEYS * hkv * w * g / INT32_OP_PER_S),
        library_ms=None))
    log(f"{rows[-1]['name']}: kernel {rows[-1]['ms']:.6g} ms, plain "
        f"{rows[-1]['plain_ms']:.6g} ms, bound {rows[-1]['bound_ms']:.6g} "
        f"ms by {rows[-1]['bound_by']}")
    del kp, got, want, a

    # --- kernel 3: the contiguous long_500k decode step (B * H_kv = 8
    # matrices of the G = 4 rows of a kv head)
    k = long_words(gen, hkv, LONG_KEYS, w)
    q = long_words(gen, hkv, g, w)
    for kv in (LONG_FILLED + 1, LONG_KEYS):
        kvl = torch.full((hkv,), kv, **i32)
        a = (q, k, (kvl - 1)[:, None].expand(hkv, g).contiguous(), kvl)
        got = btk.bacam_topk_stage1(*a, d=d, sq=1)
        want = btk.bacam_topk_stage1_plain(*a, d=d)
        n_valid, n_dead = check_candidates(
            f"bacam_topk_stage1 long_500k kv_len {kv}", got, want, 16, 2)
        log(f"bacam_topk_stage1 long_500k ({hkv} x {g} rows, {LONG_KEYS} "
            f"keys, W={w}) kv_len {kv}: bit-exact ({n_valid} valid "
            f"candidates, {n_dead} fully masked groups)")
    bytes_ = (q.numel() * 4 + k.numel() * 4 + a[2].numel() * 4 + hkv * 4
              + 2 * got[0].numel() * 4)
    rows.append(dict(
        name=LONG_ROWS["bacam_topk_stage1"], route="cuda",
        path="phase 18 (c): mistral-nemo-12b camformer long_500k "
             "contiguous decode (use_kernel)",
        source="src/repro_torch/csrc/bacam_topk.cu",
        replaces="src/repro/kernels/bacam_topk.py:154", max_abs_err=0.0,
        ms=cuda_ms(lambda: btk.bacam_topk_stage1(*a, d=d, sq=1),
                   flush=flush),
        plain_ms=cuda_ms(lambda: btk.bacam_topk_stage1_plain(*a, d=d),
                         flush=flush),
        **bound(bytes_, 3 * LONG_KEYS * hkv * w * g / INT32_OP_PER_S),
        library_ms=None))
    log(f"{rows[-1]['name']}: kernel {rows[-1]['ms']:.6g} ms, plain "
        f"{rows[-1]['plain_ms']:.6g} ms, bound {rows[-1]['bound_ms']:.6g} "
        f"ms by {rows[-1]['bound_by']}")
    del k, got, want, a

    # --- kernels 2 and 2b on the 2-slot pools of prefill_32k / decode_32k
    b, np_ = LONG_SLOTS, LONG_LEN // LONG_PAGE
    shape = (1 + b * np_, hkv, LONG_PAGE, d)
    kpool = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vpool = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    table = (torch.randperm(b * np_, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(b, np_)
    chunk_pos = LONG_PROMPT // LONG_CHUNK * LONG_CHUNK  # 28,672
    for name, sq, kv, qpos in (
            ("paged_flash_decode", 1, LONG_LEN, LONG_LEN - 1),
            ("paged_flash_decode (sq>1)", LONG_CHUNK, LONG_PROMPT,
             chunk_pos)):
        kv_len = torch.full((b,), kv, **i32)
        q_pos = torch.full((b,), qpos, **i32)
        qr = torch.randn((b, hkv, g * sq, d), generator=gen,
                         device=dev) * d**-0.5
        a = (qr, kpool, vpool, table, kv_len, q_pos)
        got = pfd.paged_flash_decode(*a, sq=sq)
        want = pfd.paged_flash_decode_ref(*a, sq=sq)
        err, ok = close(got, want, 1e-5)
        design, _ = pfd.plan(b, hkv, g * sq, d, d, LONG_PAGE, np_, sq, True)
        label = (f"{name} {LONG_ROWS[name].split('[')[1][:-1]} ({b} slots, "
                 f"{g * sq} rows a kv head, kv_len {kv}, design "
                 f"{pfd.DESIGNS[design]})")
        assert ok, f"{label}: max abs err {err}"
        log(f"{label}: max abs err {err:.3g} (tol 1e-5 rel+abs)")
        del want
        pairs = causal_keys(kv_len.cpu(), q_pos.cpu(), sq)
        bytes_ = (qr.numel() * 4 + 2 * b * kv * hkv * d * 2
                  + table.numel() * 4 + 2 * b * 4 + got.numel() * 4)
        # QK^T and PV, 2 FLOPs a multiply-add, over the causal (row, key)
        # pairs of each of the G rows
        flops = 2 * 2 * pairs * hkv * d * g
        op_s = (max(flops / 2 / F32_FLOP_PER_S,
                    3 * flops / 2 / BF16_TC_FLOP_PER_S)
                if pfd.DESIGNS[design] == "chunk tiles"
                else flops / F32_FLOP_PER_S)
        rows.append(dict(
            name=LONG_ROWS[name], route="cuda",
            path=(f"phase 18 (a): mistral-nemo-12b dense "
                  f"{'prefill chunks' if sq > 1 else 'decode'}, 2 x 32,768"),
            source="src/repro_torch/csrc/paged_flash_decode.cu",
            replaces="src/repro/kernels/paged_flash_decode.py:228",
            max_abs_err=err,
            ms=cuda_ms(lambda: pfd.paged_flash_decode(*a, sq=sq),
                       flush=flush),
            plain_ms=cuda_ms(lambda: pfd.paged_flash_decode_ref(*a, sq=sq),
                             flush=flush),
            **bound(bytes_, op_s),
            library_ms=cuda_ms(library_attention(a, sq), flush=flush)))
        log(f"{rows[-1]['name']}: kernel {rows[-1]['ms']:.6g} ms, plain "
            f"{rows[-1]['plain_ms']:.6g} ms, SDPA "
            f"{rows[-1]['library_ms']:.6g} ms, bound "
            f"{rows[-1]['bound_ms']:.6g} ms by {rows[-1]['bound_by']}")
        del got, qr, a
    torch.cuda.synchronize()
    return rows


def bound(bytes_, op_s):
    byte_s = bytes_ / HBM_BYTES_PER_S
    return dict(bound_ms=max(byte_s, op_s) * 1e3,
                bound_by="bytes" if byte_s >= op_s else "operations")


def library_attention(a, sq, binary=False):
    """One PyTorch call computing the same attention on K/V gathered
    into logical order beforehand (a yardstick; the port never calls
    it), with the keys binarized beforehand too in binary mode.  Masked
    keys get -inf through a boolean mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import paged_gather_ref

    qr, kpool, vpool, table, kv_len, q_pos = a
    k = paged_gather_ref(kpool, table).float()
    if binary:
        k = torch.where(k > 0, 1.0, -1.0)
    v = paged_gather_ref(vpool, table).float()
    s_log = k.shape[2]
    kpos = torch.arange(s_log, device=qr.device)
    qrow = q_pos[:, None] + torch.arange(qr.shape[2], device=qr.device) % sq
    mask = (kpos[None, None] < kv_len[:, None, None]) & \
        (kpos[None, None] <= qrow[:, :, None])
    mask = mask[:, None] | (kv_len == 0)[:, None, None, None]
    return lambda: F.scaled_dot_product_attention(qr, k, v, attn_mask=mask,
                                                  scale=1.0)


# the contiguous slice: 8 prompts of 896 tokens in a 1024-token cache
CONTIG_B, CONTIG_PROMPT, CONTIG_CACHE = 8, 896, 1024
CONTIG_DECODE, CONTIG_CHUNK, CONTIG_CHUNK_DECODE = 127, 128, 31
# phase 15 (a) runs leg (a) again through the sharded steps, cut to its
# first SERVE_SPLIT_STEPS decode steps, against leg (a)'s logits
SERVE_SPLIT_STEPS = 32
CONTIG_RECORD = {}
FLASH_BF16_TOL = 2**-7  # one bf16 rounding step of an f32 result


def contiguous_kernel_phase(flush):
    """The contiguous path's kernels at its own shapes (camformer-bert:
    8 prompts x 16 kv heads = 128 (b, kv head) rows, d = 64), and the two
    kernels that no model path runs (bit-sliced VMM, contiguous flash
    attention) at the same widths."""
    import torch.nn.functional as F

    from repro_torch.kernels import bacam_mvm as bmvm
    from repro_torch.kernels import bacam_topk as btk
    from repro_torch.kernels import bitslice_vmm as bsv
    from repro_torch.kernels import flash_attention as fla

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    bh, w, d = CONTIG_B * 16, 2, 64

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             device=dev, dtype=torch.int32)

    # --- bacam_mvm at the whole-prompt prefill: (128, 896, 896), W = 2
    s = CONTIG_PROMPT
    q, k = words(bh, s, w), words(bh, s, w)
    got = bmvm.bacam_mvm(q, k, d=d)
    want = bmvm.bacam_scores_ref(q, k, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "bacam_mvm differs from its plain version"
    log(f"bacam_mvm ({bh}, {s}, {s}) W={w}: bit-exact")
    from repro_torch.core.bacam import unpack_bits

    qf = unpack_bits(q, d).to(torch.bfloat16)  # the same ±1 operands
    kf = unpack_bits(k, d).to(torch.bfloat16)
    assert torch.equal(torch.matmul(qf, kf.transpose(1, 2)).to(torch.int32),
                       got), "bf16 matmul yardstick is not exact"
    bf16_ms = cuda_ms(lambda: torch.matmul(qf, kf.transpose(1, 2)),
                      flush=flush)
    # the yardstick that writes 4-byte scores, as the function does
    # (exact: sums of 64 products of ±1)
    library = lambda: torch.bmm(qf, kf.transpose(1, 2),
                                out_dtype=torch.float32)
    assert torch.equal(library().to(torch.int32), got), \
        "f32-output bmm yardstick is not exact"
    log(f"bacam_mvm yardsticks: bf16 matmul (2-byte scores) {bf16_ms:.6g} "
        f"ms")
    outputs = bh * s * s
    rows.append(dict(
        name="bacam_mvm", route="cuda",
        path="contiguous: camformer-bert prefill; phase 12: whisper-medium "
             "and recurrentgemma-2b through the unsharded and the sharded "
             "step; phase 14: the unsplit blocks and the shares of "
             "whisper-medium at m = 2 (and its decoder at m = 4) and of "
             "recurrentgemma-2b",
        source="src/repro_torch/csrc/bacam_mvm.cu",
        replaces="src/repro/kernels/bacam_mvm.py:62", max_abs_err=0.0,
        ms=cuda_ms(lambda: bmvm.bacam_mvm(q, k, d=d), flush=flush),
        plain_ms=cuda_ms(lambda: bmvm.bacam_scores_ref(q, k, d),
                         flush=flush),
        # each input read once, the int32 scores written once; xor, popc
        # and add per word of each score
        **bound(2 * bh * s * w * 4 + outputs * 4,
                3 * w * outputs / INT32_OP_PER_S),
        library_ms=cuda_ms(library, flush=flush)))
    log(f"bacam_mvm: kernel {rows[-1]['ms']:.6g} ms, f32-output bmm "
        f"{rows[-1]['library_ms']:.6g} ms, bound {rows[-1]['bound_ms']:.6g}"
        f" ms")
    del got, want, qf, kf

    # --- bacam_topk_stage1: a decode step (R = 1, ragged kv_len up to
    # 1024, q_pos = kv_len - 1) and the last 128-row chunk of the chunked
    # prefill (q_pos 768..895, kv_len 896), checked and timed; checked only:
    # the first chunk (q_pos 0..127, kv_len 128: seven eighths of the key
    # tiles masked for every row), a chunk whose groups all tie (one key
    # word per group) and stage1_k = group = 32
    lens = torch.tensor([1024, 1000, 897, 960, 1023, 900, 512, 1],
                        dtype=torch.int32, device=dev)[:CONTIG_B]
    k = words(bh, CONTIG_CACHE, w)
    kv_len = lens.repeat_interleave(16)
    full = lambda n: torch.full((bh,), n, dtype=torch.int32, device=dev)
    chunk_pos = lambda c0: (c0 + torch.arange(
        CONTIG_CHUNK, dtype=torch.int32, device=dev))[None].expand(
            bh, -1).contiguous()
    last = CONTIG_PROMPT - CONTIG_CHUNK
    k_ties = k[:, ::16].repeat_interleave(16, 1)
    default = dict(group=16, stage1_k=2)
    cases = [  # label, row name when timed, q, keys, q_pos, kv_len, options
        ("decode step", "bacam_topk_stage1", words(bh, 1, w), k,
         (kv_len - 1)[:, None].contiguous(), kv_len, default),
        ("last prefill chunk", "bacam_topk_stage1 (sq>1)",
         words(bh, CONTIG_CHUNK, w), k, chunk_pos(last), full(CONTIG_PROMPT),
         default),
        ("first prefill chunk", None, words(bh, CONTIG_CHUNK, w), k,
         chunk_pos(0), full(CONTIG_CHUNK), default),
        ("prefill chunk, all ties", None, words(bh, CONTIG_CHUNK, w), k_ties,
         chunk_pos(last), full(CONTIG_PROMPT), default),
        ("prefill chunk, stage1_k = group = 32", None,
         words(bh, CONTIG_CHUNK, w), k, chunk_pos(last), full(CONTIG_PROMPT),
         dict(group=32, stage1_k=32))]
    for label, name, qq, kk, q_pos, kvl, opts in cases:
        kw = dict(d=d, causal=True, **opts)
        got = btk.bacam_topk_stage1(qq, kk, q_pos, kvl, **kw)
        want = btk.bacam_topk_stage1_plain(qq, kk, q_pos, kvl, **kw)
        n_valid, n_dead = check_candidates(f"bacam_topk_stage1 {label}", got,
                                           want, opts["group"],
                                           opts["stage1_k"])
        log(f"bacam_topk_stage1 {label} ({bh} x {qq.shape[1]} rows, "
            f"{CONTIG_CACHE} keys, {opts}): bit-exact ({n_valid} valid "
            f"candidates, {n_dead} fully masked groups at base + s)")
        if name is None:
            continue
        run = lambda: btk.bacam_topk_stage1(qq, kk, q_pos, kvl, **kw)
        ms = cuda_ms(run, flush=flush)
        plain = cuda_ms(lambda: btk.bacam_topk_stage1_plain(
            qq, kk, q_pos, kvl, **kw), flush=flush)
        # the live keys each row needs, read once per (b, kv head) row set
        pairs = int(torch.minimum(kvl[:, None], q_pos + 1).clamp(
            min=0).sum())
        live = int(torch.clamp(torch.minimum(kvl, q_pos.max(1).values + 1),
                               min=0).sum())
        bytes_ = (qq.numel() * 4 + live * w * 4 + q_pos.numel() * 4
                  + kvl.numel() * 4 + 2 * got[0].numel() * 4)
        rows.append(dict(
            name=name, route="cuda", path="contiguous",
            source="src/repro_torch/csrc/bacam_topk.cu",
            replaces="src/repro/kernels/bacam_topk.py:154", max_abs_err=0.0,
            ms=ms, plain_ms=plain,
            **bound(bytes_, 3 * w * pairs / INT32_OP_PER_S), library_ms=None))
        log(f"bacam_topk_stage1 {label}: kernel {ms:.6g} ms"
            f", plain {plain:.6g} ms, bound {rows[-1]['bound_ms']:.6g} ms "
            f"by {rows[-1]['bound_by']} ({pairs} live (row, key) pairs)")
    # the chunk's time against its stores: the first chunk (seven eighths
    # of its (row, group) pairs masked, so nearly all stores) and two
    # fill_() of the candidate tensors (the same 16.8 MB, one launch each)
    _, _, qq, kk, q_pos, kvl, opts = cases[2]
    first_ms = cuda_ms(lambda: btk.bacam_topk_stage1(
        qq, kk, q_pos, kvl, d=d, causal=True, **opts), flush=flush)
    vals, idx = (torch.empty((bh, CONTIG_CHUNK, 2 * CONTIG_CACHE // 16),
                             dtype=torch.int32, device=dev) for _ in range(2))

    def fills():
        vals.fill_(0)
        idx.fill_(0)

    log(f"bacam_topk_stage1 (sq>1) against its stores: first prefill chunk "
        f"{first_ms:.6g} ms, two fill_() of the candidate tensors "
        f"({2 * vals.numel() * 4} bytes) {cuda_ms(fills, flush=flush):.6g}"
        f" ms")
    del k, k_ties, cases, vals, idx

    # --- bitslice_vmm at bits 4 and 8 on (128, 896, 64) x (128, 896, 64):
    # the kernel (one launch), its plain version, the f32 matmul yardstick
    # and its earlier design, the per-plane loop over bacam_mvm, for before
    # and after in one run (its bacam_mvm launches are not path launches)
    n = CONTIG_PROMPT
    times = {}
    x = torch.where(torch.randn((bh, n, d), generator=gen, device=dev) > 0,
                    1.0, -1.0)
    for bits in (4, 8):
        wi = torch.randint(-(2 ** (bits - 1)), 2 ** (bits - 1), (bh, n, d),
                           generator=gen, device=dev, dtype=torch.int32)
        launches0, mvm0 = bsv.launches, bmvm.launches
        got = bsv.bitslice_vmm(x, wi, bits=bits)
        want = bsv.bitslice_vmm_ref(x, wi, bits)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"bitslice_vmm bits={bits} differs"
        assert bsv.launches == launches0 + 1 and bmvm.launches == mvm0, \
            "bitslice_vmm is one launch of its own kernel"
        wf = wi.to(torch.float32)
        times[bits] = (
            cuda_ms(lambda: bsv.bitslice_vmm(x, wi, bits=bits), flush=flush),
            cuda_ms(lambda: bsv.bitslice_vmm_ref(x, wi, bits), flush=flush),
            # f32 (no TF32): exact, |sums| <= 64 * 128 < 2**24
            cuda_ms(lambda: torch.matmul(x, wf.transpose(1, 2)),
                    flush=flush),
            cuda_ms(lambda: bsv.plane_loop(x, wi, bits=bits), flush=flush))
        bmvm.launches = mvm0
        log(f"bitslice_vmm bits={bits} ({bh}, {n}, {d}) x ({bh}, {n}, {d}):"
            f" bit-exact, one launch, kernel {times[bits][0]:.6g} ms, plain "
            f"{times[bits][1]:.6g} ms, f32 matmul {times[bits][2]:.6g} ms, "
            f"plane loop {times[bits][3]:.6g} ms")
    outputs = bh * n * n
    ms, plain, lib, _ = times[8]
    rows.append(dict(
        name="bitslice_vmm", route="cuda", path="none",
        source="src/repro_torch/csrc/bitslice_vmm.cu",
        replaces="src/repro/kernels/bitslice_vmm.py:29", max_abs_err=0.0,
        ms=ms, plain_ms=plain,
        # x (f32) and w (int32) read once, int32 y written once; one s8
        # tensor-core product (bits <= 8: one byte limb), 2 ops per MAC
        **bound(x.numel() * 4 + wi.numel() * 4 + outputs * 4,
                2 * outputs * d / INT8_TC_OP_PER_S),
        library_ms=lib))
    del x, wi, wf, got, want

    # --- flash_attention at (128, 1024, 64), causal, f32 and bf16: one
    # kernel per input type, one row each
    sq = CONTIG_CACHE
    qkv = [torch.randn((bh, sq, d), generator=gen, device=dev)
           for _ in range(3)]
    flops = 4 * (sq * (sq + 1) // 2) * d * bh  # causal QK^T and PV
    for dtype, tol, name, source, op_s in (
            (torch.float32, 1e-5, "flash_attention_f32",
             "flash_attention_f32.cu", 3 * flops / TF32_TC_FLOP_PER_S),
            (torch.bfloat16, FLASH_BF16_TOL, "flash_attention",
             "flash_attention.cu", flops / BF16_TC_FLOP_PER_S)):
        a = [t.to(dtype) for t in qkv]
        got = fla.flash_attention(*a, causal=True)
        want = fla.flash_attention_ref(*a, causal=True)
        err, ok = close(got, want, tol)
        assert ok, f"flash_attention {dtype}: max abs err {err}"
        row = dict(
            name=name, route="cuda", path="none",
            source=f"src/repro_torch/csrc/{source}",
            replaces="src/repro/kernels/flash_attention.py:104",
            max_abs_err=err,
            ms=cuda_ms(lambda: fla.flash_attention(*a, causal=True),
                       flush=flush),
            plain_ms=cuda_ms(lambda: fla.flash_attention_ref(*a, causal=True),
                             flush=flush),
            # q, k, v read once, out written once; the operations at the
            # route's rate: bf16 tensor cores, or 3xTF32 (three TF32
            # products per f32 product) for f32
            **bound(4 * a[0].numel() * a[0].element_size(), op_s),
            # SDPA on (1, heads, S, D): its fused kernels take 4-D inputs
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                *(t[None] for t in a), is_causal=True), flush=flush))
        rows.append(row)
        route = "3xTF32" if dtype == torch.float32 else "bf16 tensor cores"
        log(f"flash_attention ({bh}, {sq}, {d}) causal {dtype}: max abs err "
            f"{err:.3g} (tol {tol:.3g} rel+abs), kernel {row['ms']:.6g} ms, "
            f"plain {row['plain_ms']:.6g} ms, SDPA {row['library_ms']:.6g} "
            f"ms, bound {row['bound_ms']:.6g} ms by {row['bound_by']} "
            f"(operations at the {route} rate)")
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# phase 4: small-width parity, card against CPU


# the parity phase's smoke configs: G = 1, G = 4 and granite's G = 3
# (MoE: 8 experts padded to 48)
PARITY_ARCHS = (("camformer-bert", {}), ("mistral-nemo-12b", {}),
                ("granite-moe-3b-a800m", dict(n_heads=6, n_kv_heads=2)))


def parity_phase():
    from repro_torch.configs import smoke_config
    from repro_torch.models import (cast_params, init_params, init_pools,
                                    lm_decode_paged, lm_page_specs,
                                    lm_prefill_paged)

    for arch, overrides in PARITY_ARCHS:
        for backend in ("dense", "camformer"):
            cfg = smoke_config(arch, attn_backend=backend, **overrides)
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
            log(f"parity {arch} smoke/{backend} (G = "
                f"{cfg.n_heads // cfg.n_kv_heads}): card vs CPU logits max "
                f"abs err {err:.3g} (tol 1e-4)")


def moe_parity_phase():
    """``apply_moe`` at one full-width granite layer (d 1536, 40 experts
    padded to 48, top-8, d_ff 512; f32 weights drawn from the seed) on
    the card against the CPU, at the slice's decode shape (8 x 1 tokens:
    one group of 8) and a prefill shape (8 x 64: 8 groups of 64): the
    routing (experts, buffer positions, keep mask) identical, outputs
    within 1e-5 and the aux values within 1e-6.  Returns the errors."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    cfg = get_config("granite-moe-3b-a800m", dtype="float32")
    gen = torch.Generator().manual_seed(SEED + 4)
    params = {name: torch.randn(shape, generator=gen) * shape[-2]**-0.5
              for name, (shape, *_) in M.moe_shapes(cfg).items()}
    on_card = {k: v.cuda() for k, v in params.items()}
    errs = {}
    for b, s in ((8, 1), (8, 64)):
        x = torch.randn((b, s, cfg.d_model), generator=gen)
        gt = M.group_size(b * s)
        cap = M.capacity(cfg, gt)
        got_r = M.route(on_card["router"], x.cuda().reshape(-1, gt,
                                                            cfg.d_model),
                        cfg, cap)
        want_r = M.route(params["router"], x.reshape(-1, gt, cfg.d_model),
                         cfg, cap)
        for name in ("eidx", "pos", "keep"):
            assert torch.equal(getattr(got_r, name).cpu(),
                               getattr(want_r, name)), \
                f"apply_moe {b}x{s}: {name} differs on the card"
        got, got_aux = M.apply_moe(on_card, x.cuda(), cfg)
        want, want_aux = M.apply_moe(params, x, cfg)
        err, ok = close(got.cpu(), want, 1e-5)
        assert ok, f"apply_moe {b}x{s}: max abs err {err}"
        aux_err = max(abs(float(got_aux[k]) - float(want_aux[k]))
                      for k in want_aux)
        assert aux_err <= 1e-6, f"apply_moe {b}x{s} aux: {aux_err}"
        errs[f"{b}x{s}"] = dict(out=err, aux=aux_err,
                                drop_frac=float(want_aux["moe_drop_frac"]))
        log(f"moe parity granite full-width layer, {b} x {s} tokens "
            f"({b * s // gt} groups of {gt}, capacity {cap}): routing "
            f"identical, "
            f"output max abs err {err:.3g} (tol 1e-5 rel+abs), aux "
            f"{aux_err:.3g} (tol 1e-6), drop share "
            f"{float(want_aux['moe_drop_frac']):.4g}")
    return errs


def contiguous_parity_phase():
    """lm_prefill + 8 lm_decode steps with use_kernel on the card
    (kernels) and on the CPU (plain versions), both fed the CPU's greedy
    picks, for smoke camformer-bert (G = 1) and smoke
    llava-next-mistral-7b (G = 4, its 8 patch embeddings prepended):
    logits within 1e-4 and the card's own picks identical."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import (cast_params, get_model_def, init_params,
                                    init_pools, lm_cache_specs)

    for arch in ("camformer-bert", "llava-next-mistral-7b"):
        cfg = smoke_config(arch, use_kernel=True)
        md = get_model_def(cfg)
        prefill, serve = make_prefill_step(md, cfg), make_serve_step(md, cfg)
        params = init_params(cfg, device="cpu", seed=SEED)
        b, s, steps = 3, 24, 8
        rng = np.random.default_rng(SEED)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                         (b, s)))}
        if cfg.n_patches:
            batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)).astype(np.float32))
        s += cfg.n_patches
        logits, fed = {}, []
        for devname in ("cpu", "cuda"):
            dev = torch.device(devname)
            p = cast_params(params, torch.float32, dev)
            caches = init_pools(lm_cache_specs(cfg, b, s + steps), dev)
            lg, caches = prefill(p, {k: v.to(dev) for k, v in batch.items()},
                                 caches)
            out = [lg]
            pos = torch.full((b,), s, dtype=torch.int32, device=dev)
            for step in range(steps):
                if devname == "cpu":
                    fed.append(torch.argmax(out[-1], -1))
                lg, caches = serve(p, fed[step].to(dev), pos, pos + 1,
                                   caches)
                out.append(lg)
                pos = pos + 1
            logits[devname] = torch.stack(out).cpu()
        err, ok = close(logits["cuda"], logits["cpu"], 1e-4)
        assert ok, f"contiguous parity {arch}: max abs err {err}"
        assert torch.equal(logits["cuda"].argmax(-1),
                           logits["cpu"].argmax(-1)), arch
        log(f"parity {arch} smoke contiguous (use_kernel, G = "
            f"{cfg.n_heads // cfg.n_kv_heads}, {cfg.n_patches} patch "
            f"embeddings): card vs CPU logits max abs err {err:.3g} (tol "
            f"1e-4), greedy picks identical over prefill + {steps} steps")


# ---------------------------------------------------------------------------
# phase 5: the slice at full width


def profiled(run):
    """Run ``run()`` under torch.profiler: wall time, device-busy seconds,
    the device's idle share of the wall time and the kernels that take the
    device time; ``trace_s`` is the host time the profiler then takes to
    hand back its events.  Kept apart from the timed runs, whose numbers
    the profiler would distort.  It traces the device's activity alone
    (CUDA runtime calls and kernels, no operator events): the device
    numbers need no more, and a full-depth model's window of operator
    events took the profiler a minute to hand back."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = Counter()
    # the raw device records: building the profiler's per-event objects
    # (``prof.events()``) took 77-110 s for a step of the loops over time
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] += e.duration_ns() / 1e3
    trace_s = time.perf_counter() - t0 - wall
    busy = sum(by_name.values()) / 1e6
    return dict(
        wall_s=wall, trace_s=trace_s,
        device_busy_s=busy if busy > 0 else "not measured",
        device_idle_share=1 - busy / wall if busy > 0 else "not measured",
        top_kernels_ms=[(name[:70], us / 1e3)
                        for name, us in by_name.most_common(6)])


def slice_requests(vocab, seed, rid0=0, max_new=32, **sampling):
    """The slice's 8 requests (prompt lengths ``SLICE_LENS``)."""
    from repro_torch.serving import Request, SamplingParams

    rng = np.random.default_rng(seed)
    return [Request(prompt=[int(t) for t in rng.integers(0, vocab, n)],
                    sampling=SamplingParams(max_new=max_new, **sampling),
                    rid=rid0 + i)
            for i, n in enumerate(SLICE_LENS)]


def profile_run(eng, vocab, sampling):
    """A second, profiled run on the same engine (8 requests, 8 new
    tokens each, the timed run's sampling policy)."""
    reqs = slice_requests(vocab, SEED + 1, rid0=100, max_new=8, **sampling)
    ticks0 = eng.ticks

    def run():
        for _ in eng.stream(*reqs):
            pass

    prof = profiled(run)
    return dict(ticks=eng.ticks - ticks0, **prof)


def build_served(arch, backend, *, spec_k=0, flags=()):
    """The engine ``python -m repro_torch.launch.serve --arch <arch>
    --backend <backend> --max-batch 8 --max-len 1024 --page-size 64
    --mode overlap [--spec-k N] [flags]`` builds (``flags`` override
    the sizes): its flags parsed by ``add_engine_args`` and the engine
    built by ``build_engine``, which draws seeded random weights
    (``--seed`` 0) at the config's compute dtype, leaf by leaf, on the
    card."""
    import argparse

    from repro_torch.launch.cli import add_engine_args, build_engine

    ap = argparse.ArgumentParser()
    add_engine_args(ap, max_batch=4, max_len=128)  # launch/serve.py's
    argv = ["--arch", arch, "--backend", backend, "--max-batch", "8",
            "--max-len", "1024", "--page-size", "64", "--mode", "overlap",
            "--seed", str(SEED)]
    if spec_k:
        argv += ["--spec-k", str(spec_k)]
    return build_engine(ap.parse_args(argv + list(flags)))


def tensor_bytes(tree):
    from repro_torch.models.module import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def serve_run(backend, *, arch="camformer-bert", spec_k=0, sampling=None,
              profile=True, flags=(), requests=None, chunks=1, keep=None):
    """``arch`` at full width with seeded random weights in its compute
    dtype (bf16), served by the engine of ``build_served`` (8 slots,
    1024 tokens, 64-token pages, overlap mode, or what ``flags`` set)
    for the slice's 8 requests of 32 new tokens (or ``requests(vocab)``):
    every request finishes on ``length`` with its ``max_new``
    in-vocabulary tokens, no tick fails, one readback a tick, no plain
    version runs on the card, and the peak allocated memory, of the
    weights' draw and of the run, stays below the card's total
    (``mem_get_info``).  Without speculation the launch counts on
    ``camformer`` and ``dense`` are exact: on ``camformer`` kernel 1 once
    a layer a decode tick and no flash launch (its prefill chunks gather
    in plain PyTorch, as the reference's do); on ``dense`` kernel 2 once
    a layer a decode tick, kernel 2b once a layer a prefill chunk
    (``chunks`` a prefill tick) and no kernel-1 launch.  With ``keep``
    (a dict) the engine's weights are kept there and left out of the
    bytes that must be freed.  Returns (requests, launches, the slice
    line's numbers, layers)."""
    from repro_torch.models import count_params

    sampling = sampling or {}
    label = f"{backend}{f' spec_k={spec_k}' if spec_k else ''}"
    total = torch.cuda.mem_get_info()[1]
    live_at_entry = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_served(arch, backend, spec_k=spec_k, flags=flags)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    cfg = eng.cfg
    n_params = count_params(eng.params)
    reqs = (requests or (lambda v: slice_requests(v, SEED, **sampling)))(
        cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with plain_calls_on_card() as plain:
        t0 = time.perf_counter()
        first = {}
        n_tok = 0
        for out in eng.stream(*reqs):
            first.setdefault(out.rid, time.perf_counter() - t0)
            n_tok += out.token is not None
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    assert plain == {}, f"{label}: plain versions ran on the card {plain}"
    assert eng.tick_errors == 0, f"{label}: {eng.last_error}"
    for r in reqs:
        assert r.finish_reason == "length", (label, r.rid, r.finish_reason,
                                             r.error)
        assert len(r.tokens) == r.sampling.max_new, (label, r.rid,
                                                     len(r.tokens))
        assert all(0 <= t < cfg.vocab for t in r.tokens), (label, r.rid)
    assert eng.readbacks == eng.ticks + eng.prefill_ticks, (
        label, eng.readbacks, eng.ticks, eng.prefill_ticks)
    assert max(build_peak, peak) < total, (label, build_peak, peak, total)
    if not spec_k and backend in ("camformer", "dense"):
        n = cfg.n_layers
        flash = sum(v for k, v in launches.items()
                    if k.startswith("paged_flash_decode"))
        if backend == "camformer":
            assert launches["bacam_paged_topk_stage1"] == n * eng.ticks, (
                label, launches, eng.ticks)
            assert flash == 0, (label, launches)
        else:
            assert launches["paged_flash_decode"] == n * eng.ticks, (
                label, launches, eng.ticks)
            assert launches["paged_flash_decode (sq>1)"] == (
                n * chunks * eng.prefill_ticks), (label, launches,
                                                  eng.prefill_ticks)
            assert flash == launches["paged_flash_decode"] + launches[
                "paged_flash_decode (sq>1)"], (label, launches)
            assert launches["bacam_paged_topk_stage1"] == 0, (label,
                                                              launches)
    ttft = sorted(first.values())
    result = dict(
        wall_s=wall, ticks=eng.ticks, ticks_per_s=eng.ticks / wall,
        tokens=n_tok, tokens_per_s=n_tok / wall,
        ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
        # the tokens after each request's first, over the time after the
        # last first token
        decode_tokens_per_s=(n_tok - len(reqs)) / (wall - ttft[-1]),
        pool_gb=tensor_bytes(eng.caches) / 1e9,
        readbacks=eng.readbacks, prefill_ticks=eng.prefill_ticks,
        host_blocked_s=eng.blocked_s,
        peak_mem_gb=peak / 1e9, build_peak_mem_gb=build_peak / 1e9,
        mem_total_gb=total / 1e9, live_at_entry_gb=live_at_entry / 1e9,
        build_s=build_s, layers=cfg.n_layers,
        params=n_params, sampling=sampling,
        launches={k: v for k, v in launches.items() if v})
    if spec_k:
        assert 0 <= eng.spec_accepted <= eng.spec_proposed, label
        result.update(spec_proposed=eng.spec_proposed,
                      spec_accepted=eng.spec_accepted,
                      spec_acceptance=eng.spec_acceptance)
    log(f"slice {arch}/{label}: {json.dumps(result)}")
    if profile:
        log(f"profile {arch}/{label}: "
            f"{json.dumps(profile_run(eng, cfg.vocab, sampling))}")
    kept = 0
    if keep is not None:
        keep["params"] = eng.params
        kept = tensor_bytes(eng.params)
    del eng
    left = torch.cuda.memory_allocated() - live_at_entry - kept
    log(f"freed {arch}/{label} without gc: {left / 1e9:.6g} GB above the "
        f"run's entry still allocated{' beside the kept weights' * bool(kept)}")
    assert left < 0.25e9, (label, "engine not freed without gc", left)
    torch.cuda.empty_cache()
    return reqs, launches, result, cfg.n_layers


def slice_phase():
    """Greedy serving on ``camformer`` and ``dense``, then ``binary`` and
    ``hybrid``; returns each run's launches."""
    runs = {}
    for backend in ("camformer", "dense", "binary", "hybrid"):
        runs[backend] = serve_run(backend)[1]
    cam, dense, binary, hybrid = (runs[k] for k in (
        "camformer", "dense", "binary", "hybrid"))
    assert cam["bacam_paged_topk_stage1"] > 0, cam
    assert dense["paged_flash_decode"] > 0, dense
    assert dense["paged_flash_decode (sq>1)"] > 0, dense
    # binary: every row through the flash kernel, decode rows in its
    # binary mode; hybrid: CAM decode rows, flash-scored prefill chunks
    assert binary["paged_flash_decode (binary)"] > 0, binary
    assert binary["paged_flash_decode (sq>1)"] > 0, binary
    assert binary["paged_flash_decode"] == 0, binary
    assert hybrid["bacam_paged_topk_stage1"] > 0, hybrid
    assert hybrid["paged_flash_decode (sq>1)"] > 0, hybrid
    assert hybrid["paged_flash_decode"] == 0, hybrid
    assert hybrid["paged_flash_decode (binary)"] == 0, hybrid
    return runs


def moe_slice_phase():
    """``granite-moe-3b-a800m`` at full width and depth (32 layers, 40
    experts padded to 48, top-8, G = 3), bf16, served greedily on
    ``camformer`` and ``dense`` with ``serve_run``'s checks; returns each
    run's launches."""
    runs = {}
    for backend in ("camformer", "dense"):
        runs[backend] = serve_run(backend, arch="granite-moe-3b-a800m")[1]
    cam, dense = runs["camformer"], runs["dense"]
    assert cam["bacam_paged_topk_stage1"] > 0, cam
    assert dense["paged_flash_decode"] > 0, dense
    assert dense["paged_flash_decode (sq>1)"] > 0, dense
    return runs


SPEC_SAMPLING = dict(temperature=0.9, top_k=40, top_p=0.95)


def spec_phase():
    """Self-speculative decoding at full width: the ``binary`` drafter
    with ``spec_k = SPEC_K`` on ``dense`` and ``camformer`` targets, the
    8 requests at temperature 0.9, top-k 40, top-p 0.95, overlap mode;
    beside each, plain decode of the same requests.  Asserts the launch
    counts exactly: per decode tick, m = SPEC_K + 1 binary decode steps a
    layer and (dense target) one verify chunk a layer; per prefill tick
    one chunk a layer for the drafter and (dense target) one for the
    target; no stage-1 launch (the target runs no decode rows, and a
    camformer verify chunk gathers).  At bf16 the verify logits (chunk
    tiles) and sequential decode logits (split-KV) sum in different
    orders, so the share of tokens equal to plain decode is reported,
    not asserted."""
    runs = {}
    m = SPEC_K + 1
    for target in ("dense", "camformer"):
        spec_reqs, launches, result, n = serve_run(
            target, spec_k=SPEC_K, sampling=SPEC_SAMPLING)
        ticks, pticks = result["ticks"], result["prefill_ticks"]
        verify = f"paged_flash_decode (sq>1, verify m={VERIFY_M})"
        dense = target == "dense"
        want = {"paged_flash_decode (binary)": ticks * m * n,
                verify: ticks * n if dense else 0,
                "paged_flash_decode (sq>1)": pticks * n * (2 if dense
                                                           else 1),
                "paged_flash_decode": 0, "bacam_paged_topk_stage1": 0}
        got = {k: launches[k] for k in want}
        assert got == want, (target, got, want)
        plain_reqs, runs[f"{target} plain"], _, _ = serve_run(
            target, sampling=SPEC_SAMPLING, profile=False)
        same = sum(a == b for s, p in zip(spec_reqs, plain_reqs)
                   for a, b in zip(s.tokens, p.tokens))
        total = sum(len(p.tokens) for p in plain_reqs)
        log(f"spec camformer-bert/{target} bf16: {same}/{total} tokens "
            f"equal to plain decode ({same / total:.4g}); first "
            f"divergence per request "
            f"{[first_divergence(s.tokens, p.tokens) for s, p in zip(spec_reqs, plain_reqs)]}")
        runs[f"{target} spec"] = launches
    return runs


def first_divergence(a, b):
    """The index of the first differing token (None when equal)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def draw_dtype_check():
    """``init_params(cfg, dtype=bf16)`` on the card equals the float32
    draw cast afterwards bit for bit (camformer-bert at full width): the
    weights the serving phases draw at bf16 are the ones they served
    when the engine cast a float32 draw."""
    from repro_torch.configs import get_config
    from repro_torch.models import cast_params, init_params
    from repro_torch.models.module import tree_leaves

    cfg = get_config("camformer-bert")
    got = tree_leaves(init_params(cfg, device="cuda", seed=SEED,
                                  dtype=torch.bfloat16))
    want = tree_leaves(cast_params(init_params(cfg, device="cuda",
                                               seed=SEED), torch.bfloat16))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(
            g.view(torch.int16), w.view(torch.int16))
    log(f"init_params dtype=bf16 on the card: bit-identical to the cast "
        f"float32 draw (camformer-bert full width, {len(got)} leaves, "
        f"{sum(t.numel() for t in got)} parameters)")
    del got, want
    torch.cuda.empty_cache()


def spec_exactness_phase():
    """On the card at the f32 smoke widths: keyed draws on a CUDA logits
    tensor equal the same draws on its CPU copy, and speculative streams
    (spec_k = 2, binary drafter) equal plain decode at temperature 0.9,
    in sync and in overlap mode, on ``dense`` and ``camformer``."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import Request, SamplingParams, ServeEngine
    from repro_torch.serving import sampler as S

    rng = np.random.default_rng(SEED)
    b, v = 16, 30522
    args = [torch.from_numpy(x) for x in (
        (rng.standard_normal((b, v)) * 3).astype(np.float32),
        rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.int64),
        rng.integers(0, 1000, b).astype(np.int32),
        np.where(np.arange(b) % 4 == 1, 0.0, 0.9).astype(np.float32),
        rng.choice([0, 1, 40], b).astype(np.int32),
        rng.choice([1.0, 0.95], b).astype(np.float32))]
    got = S.sample_step_keyed(*[x.cuda() for x in args]).cpu()
    assert torch.equal(got, S.sample_step_keyed(*args)), "keyed draws"
    log(f"keyed draws ({b} rows x {v}, temperature 0.9 with greedy rows): "
        "card equal to CPU")
    for target in ("dense", "camformer"):
        cfg = smoke_config("camformer-bert", attn_backend=target)
        params = init_params(cfg, device="cuda", seed=SEED)
        streams = {}
        for mode, spec_k in (("sync", 0), ("sync", 2), ("overlap", 2)):
            eng = ServeEngine(cfg, params, max_batch=4, max_len=96,
                              page_size=8, mode=mode, spec_k=spec_k,
                              device="cuda")
            prng_ = np.random.default_rng(SEED + 2)
            reqs = [Request(prompt=[int(t) for t in
                                    prng_.integers(0, cfg.vocab, n)],
                            sampling=SamplingParams(max_new=24,
                                                    **SPEC_SAMPLING),
                            rid=i)
                    for i, n in enumerate((5, 17, 33, 9, 24, 3))]
            for _ in eng.stream(*reqs):
                pass
            assert eng.tick_errors == 0, eng.last_error
            assert eng.readbacks == eng.ticks + eng.prefill_ticks
            streams[(mode, spec_k)] = [r.tokens for r in reqs]
            if spec_k:
                acc = f"{eng.spec_accepted}/{eng.spec_proposed}"
        plain = streams[("sync", 0)]
        for key, toks in streams.items():
            assert toks == plain, (target, key)
        log(f"spec exactness camformer-bert smoke/{target} f32: spec_k=2 "
            f"streams (sync, overlap) equal plain decode at temperature "
            f"0.9 ({sum(map(len, plain))} tokens, {acc} drafts accepted)")


def contiguous_slice_phase():
    """camformer-bert at full width, bf16, use_kernel, through the launch
    steps: leg (a) whole-prompt prefill + 127 decode steps, leg (b)
    prefill_chunk=128 + 31 steps.  Returns the launches of each leg."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import (cast_params, init_params, init_pools,
                                    lm_cache_specs, make_model_def)

    md = make_model_def()
    base = get_config("camformer-bert", use_kernel=True)
    params = cast_params(init_params(base, device="cuda", seed=SEED),
                         torch.bfloat16)
    n_layers, b = base.n_layers, CONTIG_B
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, base.vocab, (b, CONTIG_PROMPT))).to("cuda")
    legs = {}
    for leg, chunk, steps in (("a", 0, CONTIG_DECODE),
                              ("b", CONTIG_CHUNK, CONTIG_CHUNK_DECODE)):
        cfg = base.replace(prefill_chunk=chunk)
        prefill, serve = make_prefill_step(md, cfg), make_serve_step(md, cfg)
        caches = init_pools(lm_cache_specs(cfg, b, CONTIG_CACHE), "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with plain_calls_on_card() as plain:
            t0 = time.perf_counter()
            logits, caches = prefill(params, {"tokens": tokens}, caches)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            at_prefill = read_launches()
            pos = torch.full((b,), CONTIG_PROMPT, dtype=torch.int32,
                             device="cuda")
            picks = []
            record = leg == "a"
            if record:  # phase 15 (a) runs the first steps again
                CONTIG_RECORD["prefill"] = logits.clone()
                CONTIG_RECORD["logits"] = []
            t0 = time.perf_counter()
            for step in range(steps):
                tok = torch.argmax(logits, -1)
                picks.append(tok)
                logits, caches = serve(params, tok, pos, pos + 1, caches)
                if record and step < SERVE_SPLIT_STEPS:
                    CONTIG_RECORD["logits"].append(logits.clone())
                pos = pos + 1
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        launches = read_launches()
        n_chunks = CONTIG_PROMPT // chunk if chunk else 0
        assert plain == {}, f"leg {leg}: plain versions ran on the card "\
            f"{plain}"
        assert at_prefill["bacam_mvm"] == (0 if chunk else n_layers), \
            at_prefill
        assert at_prefill["bacam_topk_stage1 (sq>1)"] == \
            n_chunks * n_layers, at_prefill
        assert at_prefill["bacam_topk_stage1"] == 0, at_prefill
        assert launches["bacam_topk_stage1 (sq>1)"] == n_chunks * n_layers, \
            launches
        assert launches["bacam_topk_stage1"] == steps * n_layers, launches
        assert launches["bacam_mvm"] == at_prefill["bacam_mvm"], launches
        assert torch.isfinite(logits).all(), f"leg {leg}: non-finite logits"
        picks = torch.stack(picks)
        assert bool(((picks >= 0) & (picks < base.vocab)).all()), leg
        legs[leg] = launches
        if leg == "a":  # 8 more steps, profiled, after the timed ones
            state = dict(logits=logits, caches=caches, pos=pos)

            def run():
                for _ in range(8):
                    state["logits"], state["caches"] = serve(
                        params, torch.argmax(state["logits"], -1),
                        state["pos"], state["pos"] + 1, state["caches"])
                    state["pos"] = state["pos"] + 1

            state["pos"] = state["pos"] - 8  # rewrite the last 8 slots
            log(f"profile contiguous decode (8 steps): "
                f"{json.dumps(profiled(run))}")
            del state
        log(f"contiguous slice leg ({leg}) camformer-bert use_kernel "
            f"prefill_chunk={chunk}: " + json.dumps(dict(
                batch=b, prompt=CONTIG_PROMPT, cache_len=CONTIG_CACHE,
                prefill_chunks=n_chunks, prefill_s=prefill_s,
                decode_steps=steps, decode_s=decode_s,
                decode_tokens_per_s=b * steps / decode_s,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                plain_calls_on_card=sum(plain.values()),
                launches={k: v for k, v in launches.items() if v})))
        del caches, logits
        torch.cuda.empty_cache()
    return legs


# the VLM leg: llava-next-mistral-7b at full width, depth cut to 4 layers;
# 2 rows of 576 patch embeddings + 320 text tokens in a 1024-token cache
VLM_LAYERS, VLM_B, VLM_TEXT, VLM_DECODE = 4, 2, 320, 16
VLM_PATCHES = 576  # llava-next-mistral-7b's n_patches


def vlm_contiguous_phase():
    """``llava-next-mistral-7b`` at full width (d 4096, 32 heads on 8 kv
    heads, head_dim 128, d_ff 14336, vocab 32000), 4 of its 32 layers, f32,
    ``camformer`` with ``use_kernel``, through ``make_prefill_step`` /
    ``make_serve_step`` of its ``ModelDef``: 2 rows of 576 patch
    embeddings (the vision stub) and 320 text tokens, whole-prompt
    prefill (kernel 4, one launch a layer) and 16 greedy decode steps
    (kernel 3, one a layer a step), launch counts exact and no plain
    version on the card.  Returns that run's launches.

    Held, all fed the card's greedy picks, against: the same model on the
    card with ``use_kernel`` off (the plain association path, the same
    device's arithmetic: logits within 1e-5); the CPU (the kernels' plain
    versions) at the depth of one layer, within 1e-4; and the CPU on the
    ``dense`` backend at the full 4 layers, within 1e-4.  Deeper camformer
    stacks are not held to the CPU: a binarized q or k component within
    f32 rounding of zero takes another sign on the other device (rope at
    positions near 900 alone moves q by up to 2e-4), a score then moves
    by 2 across a top-32 boundary, and the next layer amplifies it; the
    4-layer card-vs-CPU error is printed."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import (cast_params, count_params,
                                    get_model_def, init_params, init_pools,
                                    lm_cache_specs)

    base = get_config("llava-next-mistral-7b", n_layers=VLM_LAYERS,
                      attn_backend="camformer", use_kernel=True,
                      dtype="float32")
    n_img, b = base.n_patches, VLM_B
    assert n_img == VLM_PATCHES, n_img
    cache_len = CONTIG_CACHE
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(
                 rng.integers(0, base.vocab, (b, VLM_TEXT))),
             "image_embeds": torch.from_numpy(
                 (rng.standard_normal((b, n_img, base.d_model))
                  * base.d_model**-0.5).astype(np.float32))}
    params = init_params(base, device="cpu", seed=SEED)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def run(cfg, dev, picks=None, counted=False, profile=False):
        md = get_model_def(cfg)
        prefill, serve = make_prefill_step(md, cfg), make_serve_step(md, cfg)
        p = cast_params(dict(params, blocks=params["blocks"][:cfg.n_layers]),
                        torch.float32, dev)
        caches = init_pools(lm_cache_specs(cfg, b, cache_len), dev)
        bt = {k: v.to(dev) for k, v in batch.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        times = {}
        with plain_calls_on_card() as plain:
            if counted:
                reset_launches()
            t0 = time.perf_counter()
            lg, caches = prefill(p, bt, caches)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times["prefill_s"] = time.perf_counter() - t0
            at_prefill = read_launches(families=True)
            out, fed = [lg], []
            pos = torch.full((b,), n_img + VLM_TEXT, dtype=torch.int32,
                             device=dev)
            t0 = time.perf_counter()
            for step in range(VLM_DECODE):
                tok = (torch.argmax(out[-1], -1) if picks is None
                       else picks[step].to(dev))
                fed.append(tok)
                lg, caches = serve(p, tok, pos, pos + 1, caches)
                out.append(lg)
                pos = pos + 1
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times["decode_s"] = time.perf_counter() - t0
            launches = read_launches(families=True)
        result = dict(logits=torch.stack(out).cpu(),
                      picks=[t.cpu() for t in fed], launches=launches,
                      at_prefill=at_prefill, plain=plain, **times)
        if dev.type == "cuda":
            result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if profile:  # 8 more steps after the counted ones
            state = dict(logits=lg, caches=caches, pos=pos)

            def steps():
                for _ in range(8):
                    state["logits"], state["caches"] = serve(
                        p, torch.argmax(state["logits"], -1), state["pos"],
                        state["pos"] + 1, state["caches"])
                    state["pos"] = state["pos"] + 1

            result["profile"] = profiled(steps)
        del caches, p
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return result

    card = run(base, cuda, counted=True, profile=True)
    launches, plain = card["launches"], card["plain"]
    assert plain == {}, f"vlm leg: plain versions ran on the card {plain}"
    assert card["at_prefill"][LLAVA_ROW] == VLM_LAYERS, card["at_prefill"]
    assert card["at_prefill"]["bacam_topk_stage1"] == 0, card["at_prefill"]
    assert launches[LLAVA_ROW] == VLM_LAYERS, launches
    assert launches["bacam_mvm"] == 0, launches
    assert launches["bacam_topk_stage1"] == VLM_DECODE * VLM_LAYERS, launches
    assert launches["bacam_topk_stage1 (sq>1)"] == 0, launches
    assert torch.isfinite(card["logits"]).all(), "vlm leg: non-finite"
    picks = card["picks"]
    assert all(bool(((t >= 0) & (t < base.vocab)).all()) for t in picks)
    errs = {}
    plain_route = run(base.replace(use_kernel=False), cuda, picks=picks)
    errs["card plain route"], ok = close(card["logits"],
                                         plain_route["logits"], 1e-5)
    assert ok, f"vlm leg: kernel vs plain route on the card {errs}"
    one = base.replace(n_layers=1)
    errs["CPU, 1 layer"], ok = close(run(one, cuda, picks=picks)["logits"],
                                     run(one, cpu, picks=picks)["logits"],
                                     1e-4)
    assert ok, f"vlm leg: card vs CPU at 1 layer {errs}"
    dense = base.replace(attn_backend="dense", use_kernel=False)
    errs["CPU, dense, 4 layers"], ok = close(
        run(dense, cuda, picks=picks)["logits"],
        run(dense, cpu, picks=picks)["logits"], 1e-4)
    assert ok, f"vlm leg: dense card vs CPU {errs}"
    errs["CPU, 4 layers (not held)"], _ = close(
        card["logits"], run(base, cpu, picks=picks)["logits"], 1e-4)
    log(f"vlm parity llava-next-mistral-7b: logits max abs err "
        f"{json.dumps(errs)} (tol 1e-5 card plain route, 1e-4 CPU)")
    log("profile llava-next-mistral-7b contiguous decode (8 steps): "
        f"{json.dumps(card['profile'])}")
    log(f"vlm leg llava-next-mistral-7b camformer use_kernel f32: "
        + json.dumps(dict(
            layers=VLM_LAYERS, batch=b, patches=n_img, text=VLM_TEXT,
            positions=n_img + VLM_TEXT, cache_len=cache_len,
            prefill_s=card["prefill_s"], decode_steps=VLM_DECODE,
            decode_s=card["decode_s"],
            decode_tokens_per_s=b * VLM_DECODE / card["decode_s"],
            peak_mem_gb=card["peak_mem_gb"], params=count_params(params),
            launches={k: v for k, v in launches.items() if v})))
    return launches


# ---------------------------------------------------------------------------
# phase 8: training

# the full-width train step: 8 rows of 1024 tokens (the paper's n), so
# kernel 4 scores (8 x 16 kv heads, 1024, 1024) a layer and pass
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 1024, 12, 6
TRAIN_SHAPE = "train_8x1024"
TRAIN_ROW = "bacam_mvm (train)"
TRAIN_LINES = {}  # phase 8's full-width runs by backend, read by phase 12


def train_kernel_phase(flush):
    """Kernel 4 at the camformer-bert train step's shape: (128, 1024,
    1024), W = 2, bit-exact against its plain version, timed beside the
    plain version and ``torch.bmm`` of the ±1 bf16 operands (4-byte
    scores)."""
    from repro_torch.core.bacam import unpack_bits
    from repro_torch.kernels import bacam_mvm as bmvm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    bh, s, w, d = TRAIN_B * 16, TRAIN_S, 2, 64
    q, k = (torch.randint(-2**31, 2**31 - 1, (bh, s, w), generator=gen,
                          device=dev, dtype=torch.int32) for _ in range(2))
    got = bmvm.bacam_mvm(q, k, d=d)
    want = bmvm.bacam_scores_ref(q, k, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want), \
        "bacam_mvm at the training shape differs from its plain version"
    del want
    qf, kf = unpack_bits(q, d).to(torch.bfloat16), unpack_bits(
        k, d).to(torch.bfloat16)
    library = lambda: torch.bmm(qf, kf.transpose(1, 2),
                                out_dtype=torch.float32)
    assert torch.equal(library().to(torch.int32), got), \
        "f32-output bmm yardstick is not exact"
    outputs = bh * s * s
    row = dict(
        name=TRAIN_ROW, route="cuda",
        path="train: camformer-bert camformer use_kernel (forward and "
             "recompute, every layer; phase 12 through the sharded step); "
             "HAD student (binary, camformer)",
        source="src/repro_torch/csrc/bacam_mvm.cu",
        replaces="src/repro/kernels/bacam_mvm.py:62", max_abs_err=0.0,
        ms=cuda_ms(lambda: bmvm.bacam_mvm(q, k, d=d), flush=flush),
        plain_ms=cuda_ms(lambda: bmvm.bacam_scores_ref(q, k, d),
                         flush=flush, n=10),
        # packed operands read once (2,097,152 B), int32 scores written
        # once (536,870,912 B); xor, popc and add per word of each score
        **bound(2 * bh * s * w * 4 + outputs * 4,
                3 * w * outputs / INT32_OP_PER_S),
        library_ms=cuda_ms(library, flush=flush))
    log(f"{TRAIN_ROW} ({bh}, {s}, {s}) W={w}: bit-exact; kernel "
        f"{row['ms']:.6g} ms, plain {row['plain_ms']:.6g} ms, f32-output "
        f"bmm {row['library_ms']:.6g} ms, bound {row['bound_ms']:.6g} ms")
    return [row]


def only_bacam_mvm(launches):
    """No kernel but kernel 4 launched (the training path's only one)."""
    return all(v == 0 for k, v in launches.items() if k != "bacam_mvm")


@contextlib.contextmanager
def recorded_scores():
    """Record the integer BA-CAM score matrices of the binary and
    camformer attention: the kernel route's (``kernels/ops.bacam_scores``,
    reshaped to the plain layout by the caller) and the plain route's
    (``core/bacam.bacam_scores``), in call order."""
    from repro_torch.core import bacam
    from repro_torch.kernels import ops

    calls = []
    saved = {mod: mod.bacam_scores for mod in (bacam, ops)}

    def recorder(fn):
        def rec(*a, **kw):
            out = fn(*a, **kw)
            calls.append(out.detach().reshape(-1, out.shape[-1]).cpu())
            return out
        return rec

    for mod, fn in saved.items():
        mod.bacam_scores = recorder(fn)
    try:
        yield calls
    finally:
        for mod, fn in saved.items():
            mod.bacam_scores = fn


TRAIN_PARITY = (("camformer-bert", {}),
                ("granite-moe-3b-a800m", dict(n_heads=6, n_kv_heads=2)))


def train_parity_phase():
    """The train step's loss and gradients (f32 smoke width, remat, the
    camformer backend) on the card: kernel route (``use_kernel``) against
    the card's plain route (integer scores identical, loss and every
    gradient leaf within 1e-6), and against the CPU (loss within 1e-5,
    gradient leaves within 1e-4).  ``camformer-bert`` (G = 1) and
    ``granite-moe-3b-a800m`` (G = 3, the MoE backward)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_value_and_grad
    from repro_torch.models import cast_params, get_model_def, init_params
    from repro_torch.models.module import tree_leaves

    out = {}
    for arch, overrides in TRAIN_PARITY:
        cfg = smoke_config(arch, attn_backend="camformer", use_kernel=True,
                           **overrides)
        params = init_params(cfg, device="cpu", seed=SEED)
        rng = np.random.default_rng(SEED)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
                 for k in ("tokens", "labels")}

        def run(c, dev):
            with recorded_scores() as scores:
                loss, _, grads = make_value_and_grad(get_model_def(c), c)(
                    cast_params(params, torch.float32, dev),
                    {k: v.to(dev) for k, v in batch.items()})
            return loss.cpu(), [g.cpu() for g in tree_leaves(grads)], scores

        reset_launches()
        with plain_calls_on_card() as plain:
            kernel = run(cfg, torch.device("cuda"))
        launches = read_launches()
        assert plain == {}, f"train parity {arch}: plain on the card {plain}"
        assert launches["bacam_mvm"] == 2 * cfg.n_layers, launches
        assert only_bacam_mvm(launches), launches
        route = run(cfg.replace(use_kernel=False), torch.device("cuda"))
        cpu = run(cfg, torch.device("cpu"))
        assert len(kernel[2]) == len(route[2]) == 2 * cfg.n_layers
        assert all(torch.equal(a, b) for a, b in zip(kernel[2], route[2])), \
            f"train parity {arch}: kernel scores differ from the plain route"
        errs = {}
        for name, other, tol in (("card plain route", route, 1e-6),
                                 ("CPU", cpu, (1e-5, 1e-4))):
            lt, gt = tol if isinstance(tol, tuple) else (tol, tol)
            e_loss, ok_loss = close(kernel[0], other[0], lt)
            e_grad = max(close(a, b, gt)[0] for a, b in
                         zip(kernel[1], other[1]))
            ok_grad = all(close(a, b, gt)[1] for a, b in
                          zip(kernel[1], other[1]))
            errs[name] = dict(loss=e_loss, grad=e_grad)
            assert ok_loss and ok_grad, f"train parity {arch}: {name} {errs}"
        assert torch.isfinite(kernel[0]), kernel[0]
        out[arch] = errs
        log(f"train parity {arch} smoke camformer use_kernel (G = "
            f"{cfg.n_heads // cfg.n_kv_heads}): scores identical to the "
            f"plain route; max abs err {json.dumps(errs)} (tol 1e-6 plain "
            f"route, 1e-5 loss / 1e-4 grads CPU)")
    return out


def train_shape(b, s):
    """Register a train batch of ``b`` rows of ``s`` tokens in ``SHAPES``
    (as ``train_4k`` is registered) and return its name."""
    from repro_torch.configs import SHAPES

    name = f"train_{b}x{s}"
    SHAPES[name] = dict(seq_len=s, global_batch=b, kind="train")
    return name


def train_run(cfg, shape, *, ckpt_dir, total_steps, ckpt_every,
              profile=False, peak_lr=3e-4):
    """``Trainer`` over ``cfg`` at the batch of ``shape`` (a ``SHAPES``
    name) on the card (cosine schedule to ``peak_lr``, warmup 2, f32
    masters, seeded init and data), launches counted and plain versions
    refused, the step logged every step; returns {"trainer", "state",
    "launches", "wall_s", "peak_gb", "metrics" (every step's
    ``METRIC_KEYS`` as floats), "profile"}.  With ``profile`` the last
    step of a fresh run runs under ``profiled`` (its logged time then
    holds the profiler's hand-back: leave it out of the median)."""
    from repro_torch.models import get_model_def
    from repro_torch.train.data import SyntheticLMData
    from repro_torch.train.trainer import Trainer, TrainerConfig

    data = SyntheticLMData(cfg, shape, seed=SEED, device="cuda")
    tcfg = TrainerConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                         ckpt_dir=str(ckpt_dir), keep=1, log_every=1,
                         peak_lr=peak_lr, warmup=2, seed=SEED)
    trainer = Trainer(get_model_def(cfg), cfg, data, tcfg, device="cuda")
    step_fn, metrics, prof = trainer.step_fn, [], {}

    def recorded(state, batch):
        if profile and len(metrics) == total_steps - 1:
            def last():
                prof["out"] = step_fn(state, batch)
                float(prof["out"][1]["loss"])

            prof["profile"] = profiled(last)
            out = prof.pop("out")
        else:
            out = step_fn(state, batch)
        metrics.append(out[1])
        return out

    trainer.step_fn = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with plain_calls_on_card() as plain:
        reset_launches()
        t0 = time.perf_counter()
        state = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(families=True)
    assert plain == {}, f"train {cfg.name}: plain versions on the card {plain}"
    assert not profile or "profile" in prof, "a resumed run is not profiled"
    return dict(trainer=trainer, state=state, launches=launches, wall_s=wall,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                metrics=[{k: float(v) for k, v in m.items()}
                         for m in metrics], profile=prof.get("profile"))


def median_step_s(log_):
    """The median logged step time, the profiled last step left out."""
    return statistics.median(r["step_time_s"] for r in log_[:-1])


def train_phase():
    """camformer-bert at full width and depth (24 layers, d 1024, bf16
    compute, f32 masters, remat) trained through ``Trainer`` at 8 x 1024
    tokens for TRAIN_STEPS steps on ``camformer`` with ``use_kernel`` and
    on ``dense``: every loss finite and the last below the first, kernel
    4 launched 2 x 24 x steps times on camformer (forward and recompute)
    and never on dense, no plain version on the card, checkpoints every
    TRAIN_CKPT_EVERY steps and a second Trainer resuming from the last.
    Returns the camformer runs' launches."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.models import count_params

    assert train_shape(TRAIN_B, TRAIN_S) == TRAIN_SHAPE
    ckpt_root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    runs, lines = [], {}
    try:
        for backend in ("camformer", "dense"):
            cfg = get_config("camformer-bert", attn_backend=backend,
                             use_kernel=backend == "camformer")
            every = TRAIN_CKPT_EVERY if backend == "camformer" else 10**9
            run = train_run(cfg, TRAIN_SHAPE, ckpt_dir=ckpt_root / backend,
                            total_steps=TRAIN_STEPS, ckpt_every=every,
                            profile=True)
            trainer, state, prof = run["trainer"], run["state"], run["profile"]
            launches = run["launches"]
            log_ = trainer.metrics_log
            losses = [r["loss"] for r in log_]
            assert len(losses) == TRAIN_STEPS, log_
            assert all(math.isfinite(x) for x in losses), losses
            assert losses[-1] < losses[0], losses
            want = 2 * cfg.n_layers * TRAIN_STEPS if cfg.use_kernel else 0
            assert launches["bacam_mvm"] == want, launches
            assert only_bacam_mvm(launches), launches
            step_s = median_step_s(log_)
            line = dict(
                layers=cfg.n_layers, params=count_params(state["params"]),
                batch=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS,
                wall_s=run["wall_s"], median_step_s=step_s,
                tokens_per_s=TRAIN_B * TRAIN_S / step_s,
                peak_mem_gb=run["peak_gb"],
                first_loss=losses[0], last_loss=losses[-1],
                losses=losses, lr_last=log_[-1]["lr"],
                grad_norm_last=log_[-1]["grad_norm"],
                kernel4_launches=launches["bacam_mvm"],
                events=[list(e) for e in trainer.events])
            if backend == "camformer":
                from repro_torch.train.checkpoint import latest_step

                assert latest_step(str(ckpt_root / backend)) == TRAIN_STEPS
                runs.append({TRAIN_ROW: launches["bacam_mvm"]})
                del state, run
                torch.cuda.empty_cache()
                # a second Trainer resumes from the last checkpoint
                run = train_run(cfg, TRAIN_SHAPE, ckpt_dir=ckpt_root / backend,
                                total_steps=TRAIN_STEPS + 2, ckpt_every=every)
                trainer2, state, launches2 = (run["trainer"], run["state"],
                                              run["launches"])
                assert trainer2.events[0] == (
                    TRAIN_STEPS, "resume", f"restored step_{TRAIN_STEPS}"), \
                    trainer2.events
                assert [r["step"] for r in trainer2.metrics_log] == [
                    TRAIN_STEPS + 1, TRAIN_STEPS + 2], trainer2.metrics_log
                assert launches2["bacam_mvm"] == 2 * cfg.n_layers * 2
                assert all(math.isfinite(r["loss"])
                           for r in trainer2.metrics_log)
                runs.append({TRAIN_ROW: launches2["bacam_mvm"]})
                line["resume"] = dict(
                    event=list(trainer2.events[0]),
                    losses=[r["loss"] for r in trainer2.metrics_log])
            del state, run
            torch.cuda.empty_cache()
            lines[backend] = line
            TRAIN_LINES[backend] = line
            log(f"train camformer-bert {backend}"
                f"{' use_kernel' if cfg.use_kernel else ''} bf16 full width: "
                + json.dumps(line))
            log(f"profile train camformer-bert {backend} (one step): "
                + json.dumps(prof))
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    return runs


HAD_SHAPE = "had"


def had_phase():
    """The HAD recipe of ``examples/had_distill.py`` through the port's
    modules on the card, at that example's width (d 128, 2 layers, vocab
    512, 8 x 128 tokens; ``use_kernel``): 80 dense teacher steps (AdamW,
    constant lr 1e-3), eval, 40 ``binary`` student steps at lr 5e-4 from
    the teacher, eval of the student on binary and on camformer with
    single-stage (stage1_k 8) and two-stage (stage1_k 2) top-k.  Eval CE
    is the mean over 4 held-out batches.  Asserts every value finite and
    the launches of kernel 4 (twice a layer a student step, once a layer
    an eval batch); returns the launches."""
    from repro_torch.configs import SHAPES, smoke_config
    from repro_torch.launch.steps import make_value_and_grad
    from repro_torch.models import get_model_def, init_params
    from repro_torch.train.data import SyntheticLMData
    from repro_torch.train.optimizer import adamw, constant_schedule

    SHAPES[HAD_SHAPE] = dict(seq_len=128, global_batch=8, kind="train")
    base = smoke_config("codeqwen1.5-7b", d_model=128, n_layers=2, n_heads=4,
                        n_kv_heads=4, head_dim=32, vocab=512, k_top=16,
                        group_size=8, use_kernel=True)
    data = SyntheticLMData(base, HAD_SHAPE, seed=0, device="cuda")
    held = [data.batch(5000 + i) for i in range(4)]

    def train(cfg, params, steps, lr, start):
        opt = adamw(constant_schedule(lr))
        state = opt.init(params)
        vg = make_value_and_grad(get_model_def(cfg), cfg)
        for i in range(steps):
            _, _, grads = vg(params, data.batch(start + i))
            params, state, _ = opt.update(grads, state, params)
        return params

    def eval_ce(cfg, params):
        md = get_model_def(cfg)
        with torch.no_grad():
            return sum(float(md.loss(params, b, cfg)[1]["ce"])
                       for b in held) / len(held)

    t0 = time.perf_counter()
    with plain_calls_on_card() as plain:
        reset_launches()
        params = init_params(base, device="cuda", seed=0)
        params = train(base, params, 80, 1e-3, 0)
        ce = {"dense teacher": eval_ce(base, params)}
        bin_cfg = base.replace(attn_backend="binary")
        ce["binary Q/K, zero-shot"] = eval_ce(bin_cfg, params)
        student = train(bin_cfg, params, 40, 5e-4, 80)
        ce["binary Q/K after HAD fine-tune"] = eval_ce(bin_cfg, student)
        ce["HAD student + single-stage top-k"] = eval_ce(
            bin_cfg.replace(attn_backend="camformer", stage1_k=8), student)
        ce["HAD student + two-stage top-2/grp"] = eval_ce(
            bin_cfg.replace(attn_backend="camformer", stage1_k=2), student)
        launches = read_launches()
    assert plain == {}, plain
    assert all(math.isfinite(v) for v in ce.values()), ce
    n = base.n_layers
    assert launches["bacam_mvm"] == 40 * 2 * n + 4 * len(held) * n, launches
    assert only_bacam_mvm(launches), launches
    log(f"HAD recipe (examples/had_distill.py flow, {time.perf_counter() - t0:.1f}"
        f" s): eval CE {json.dumps(ce)}")
    return {TRAIN_ROW: launches["bacam_mvm"]}


def training_phase():
    """Phase 8: train-step parity, full-width camformer-bert training
    with resume, the HAD recipe.  Returns the launches of the counted
    runs."""
    train_parity_phase()
    runs = train_phase()
    runs.append(had_phase())
    return runs


# ---------------------------------------------------------------------------
# phase 9: the network gateway

GATEWAY_GAP_S = 0.05  # live traffic: one client every 50 ms
GATEWAY_KEYED = dict(temperature=0.9, top_k=40)


def gateway_engine(cfg, faults=None):
    """A fresh ``camformer-bert`` engine at phase 5's geometry (8 slots,
    1024 tokens, 64-token pages, overlap), seeded weights."""
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    params = init_params(cfg, device="cuda", seed=SEED)
    return ServeEngine(cfg, params, max_batch=8, max_len=1024, page_size=64,
                       mode="overlap", device="cuda", faults=faults)


def http_json(port, method, path, body=None):
    """One HTTP exchange: (status, the JSON body or the SSE events).  A
    client timeout raises."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body))
        resp = conn.getresponse()
        raw = resp.read()
        if resp.getheader("Content-Type") == "text/event-stream":
            out = [json.loads(line[6:]) for line in raw.split(b"\n")
                   if line.startswith(b"data: ")]
        else:
            out = json.loads(raw)
        return resp.status, out
    finally:
        conn.close()


def gateway_clients(port, bodies, gap_s):
    """One client thread per body, started ``gap_s`` apart; each returns
    (status, events, start, end).  A client that raised fails the phase."""
    import threading

    out = [None] * len(bodies)
    errors = []

    def client(i):
        try:
            t0 = time.perf_counter()
            status, events = http_json(port, "POST", "/v1/generate",
                                          bodies[i])
            out[i] = (status, events, t0, time.perf_counter())
        except Exception as e:  # raised on the main thread below
            errors.append((i, repr(e)))

    threads = []
    for i in range(len(bodies)):
        threads.append(threading.Thread(target=client, args=(i,)))
        threads[-1].start()
        time.sleep(gap_s)
    for th in threads:
        th.join(300)
    assert not any(th.is_alive() for th in threads), "a client hung"
    assert not errors, errors
    return out


def wait_idle(eng, timeout=120.0):
    """Wait (host state only) until the runner drained the engine."""
    deadline = time.monotonic() + timeout
    while eng.has_work or eng.has_pending:
        assert time.monotonic() < deadline, "the engine did not drain"
        time.sleep(0.01)


def staggered_in_process(eng, reqs, gap_s):
    """The live-traffic requests served in-process on this thread,
    submitted ``gap_s`` apart between polls; returns the reading with
    the gateway's TTFT / TPOT definitions (submit to first token, token
    to token, taken when the host routes the token)."""
    from repro_torch.serving.gateway import LatencyStats

    ttft, tpot = LatencyStats(), LatencyStats()
    submit, prev = {}, {}
    n_tok = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = list(reqs)
    while pending or eng.has_work or eng.has_pending:
        now = time.perf_counter()
        while pending and now - t0 >= gap_s * len(submit):
            submit[pending[0].rid] = now
            eng.submit(pending.pop(0))
        if not (eng.has_work or eng.has_pending):
            time.sleep(max(0.0, t0 + gap_s * len(submit) - now))
            continue
        for out in eng.poll():
            if out.token is None:
                continue
            now = time.perf_counter()
            n_tok += 1
            if out.rid in prev:
                tpot.observe((now - prev[out.rid]) * 1e3)
            else:
                ttft.observe((now - submit[out.rid]) * 1e3)
            prev[out.rid] = now
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                ttft_p50_ms=ttft.percentile(50), ttft_p99_ms=ttft.percentile(99),
                tpot_p50_ms=tpot.percentile(50), tpot_p99_ms=tpot.percentile(99))


def gateway_backend(backend, smi):
    """Phase 9 on one backend: (a) exactness against a second engine's
    in-process ``stream()``, (b) 8 live clients with exact launch counts,
    (c) a disconnect storm (``dense``), (d) the endpoints.  Returns the
    launches of (b)."""
    from repro_torch.configs import get_config
    from repro_torch.serving import (FaultPlan, FaultSpec, Request,
                                     SamplingParams)
    from repro_torch.serving.gateway import serve_background

    cfg = get_config("camformer-bert", attn_backend=backend)
    n = cfg.n_layers
    rng = np.random.default_rng(SEED + 9)
    exact = [dict(prompt=[int(t) for t in rng.integers(0, cfg.vocab, m)],
                  max_new=32, **kw)
             for m, kw in ((160, {}), (224, GATEWAY_KEYED))]
    live = slice_requests(cfg.vocab, SEED)
    live_bodies = [dict(prompt=r.prompt, max_new=32) for r in live]

    # (a) the reference: the same requests on a second fresh engine, in
    # process, before the gateway's runner thread exists; then (b)'s
    # requests in process on it, arriving as (b)'s clients do
    ref = gateway_engine(cfg)
    want = []
    for rid, body in enumerate(exact):
        sp = SamplingParams(**{k: v for k, v in body.items()
                               if k != "prompt"})
        want.append([o.token for o in ref.stream(Request(
            prompt=list(body["prompt"]), rid=rid, sampling=sp))])
    in_proc_reqs = [Request(prompt=list(r.prompt), rid=len(exact) + i,
                            sampling=SamplingParams(max_new=32))
                    for i, r in enumerate(live)]
    in_proc = staggered_in_process(ref, in_proc_reqs, GATEWAY_GAP_S)
    assert ref.tick_errors == 0, ref.last_error
    assert all(r.finish_reason == "length" for r in in_proc_reqs)
    del ref
    torch.cuda.empty_cache()

    eng = gateway_engine(cfg)
    handle = serve_background(eng, port=0)
    try:
        for rid, body in enumerate(exact):
            status, events = http_json(handle.port, "POST",
                                          "/v1/generate", body)
            assert status == 200, (backend, status, events)
            got = [e["token"] for e in events]
            assert [e["rid"] for e in events] == [rid] * len(got)
            assert [e["index"] for e in events] == list(
                range(1, len(got) + 1))
            assert events[-1]["finish_reason"] == "length"
            assert got == want[rid] == events[-1]["tokens"], (
                f"{backend} rid {rid}: gateway stream differs from "
                f"in-process at index {first_divergence(got, want[rid])}")
        assert handle.runner.is_alive()
    finally:
        assert handle.stop(), "the gateway or runner thread did not stop"
        assert not handle.runner.is_alive(), "the runner thread outlived stop()"
    wait_idle(eng)
    log(f"gateway {backend} (a): SSE == in-process stream() for rid 0 "
        f"(greedy) and rid 1 ({GATEWAY_KEYED}), 32 tokens each")

    # (b) live traffic on a fresh gateway (fresh GatewayMetrics)
    handle = serve_background(eng, port=0)
    ticks0, prefill0, reads0 = eng.ticks, eng.prefill_ticks, eng.readbacks
    try:
        reset_launches()
        with plain_calls_on_card() as plain:
            results = gateway_clients(handle.port, live_bodies,
                                      GATEWAY_GAP_S)
            wait_idle(eng)
        launches = read_launches()
        assert plain == {}, f"gateway {backend}: plain versions ran {plain}"
        assert handle.runner.is_alive()
        ticks = eng.ticks - ticks0
        prefill_ticks = eng.prefill_ticks - prefill0
        assert eng.tick_errors == 0, eng.last_error
        assert eng.readbacks - reads0 == ticks + prefill_ticks
        assert prefill_ticks > 1, "no continuous admission"
        eng.kv.check()
        for i, (status, events, _, _) in enumerate(results):
            assert status == 200, (backend, i, status)
            assert events[-1]["finish_reason"] == "length", (backend, i)
            assert len(events[-1]["tokens"]) == 32, (backend, i)
            assert [e["token"] for e in events] == events[-1]["tokens"]
        if backend == "camformer":
            assert launches["bacam_paged_topk_stage1"] == n * ticks, (
                launches, ticks)
        else:
            assert launches["paged_flash_decode"] == n * ticks, (
                launches, ticks)
            assert launches["paged_flash_decode (sq>1)"] == (
                n * prefill_ticks), (launches, prefill_ticks)
        # (d) the endpoints
        st, health = http_json(handle.port, "GET", "/healthz")
        assert st == 200 and health["device"] == "cuda", health
        assert health["backend"] == backend, health
        st, metrics = http_json(handle.port, "GET", "/metrics")
        assert st == 200
        for key in ("ticks", "readbacks", "page_pool", "queue_depth",
                    "active", "tick_errors"):
            assert key in metrics["engine"], key
        assert metrics["engine"]["tick_errors"] == 0
        assert metrics["requests"]["completed"] == len(live)
    finally:
        assert handle.stop(), "the gateway or runner thread did not stop"
        assert not handle.runner.is_alive(), "the runner thread outlived stop()"
    start = min(r[2] for r in results)
    wall = max(r[3] for r in results) - start
    n_tok = sum(len(r[1][-1]["tokens"]) for r in results)
    equal = sum(a == b for r, q in zip(results, in_proc_reqs)
                for a, b in zip(r[1][-1]["tokens"], q.tokens))
    reading = dict(
        card=smi, clients=len(live), gap_s=GATEWAY_GAP_S, tokens=n_tok,
        wall_s=wall, tokens_per_s=n_tok / wall, ticks=ticks,
        prefill_ticks=prefill_ticks,
        ttft_p50_ms=metrics["ttft_ms"]["p50_ms"],
        ttft_p99_ms=metrics["ttft_ms"]["p99_ms"],
        tpot_p50_ms=metrics["tpot_ms"]["p50_ms"],
        tpot_p99_ms=metrics["tpot_ms"]["p99_ms"],
        host_blocked_s=eng.blocked_s, in_process=in_proc,
        tokens_equal_to_in_process=f"{equal}/{n_tok}",
        launches={k: v for k, v in launches.items() if v})
    log(f"gateway camformer-bert/{backend} (b): {json.dumps(reading)}")
    torch.cuda.synchronize()
    del eng
    torch.cuda.empty_cache()

    # (c) a disconnect storm: the gateway drops 2 of 6 streams after
    # their first token (the engine's plan: its ticks arm the window)
    if backend == "dense":
        eng = gateway_engine(cfg, FaultPlan([FaultSpec(
            "gateway.disconnect", prob=1.0, times=2)]))
        handle = serve_background(eng, port=0)
        try:
            results = gateway_clients(handle.port, live_bodies[:6],
                                      GATEWAY_GAP_S)
            done = [r for r in results if r[0] == 200 and r[1]
                    and r[1][-1].get("finished")]
            assert len(done) == 4, [r[1][-1:] for r in results]
            assert all(r[1][-1]["finish_reason"] == "length" for r in done)
            counts = lambda: (handle.runner.metrics.cancelled,
                              handle.runner.metrics.completed)
            deadline = time.monotonic() + 60
            while counts() != (2, 4):
                assert time.monotonic() < deadline, counts()
                time.sleep(0.01)
            wait_idle(eng)
            eng.kv.check()
            assert eng.kv.free_pages == eng.kv.n_pages - 1
            status, events = http_json(handle.port, "POST",
                                          "/v1/generate", live_bodies[0])
            assert status == 200 and events[-1]["finish_reason"] == "length"
            assert eng.tick_errors == 0 and handle.runner.is_alive()
        finally:
            assert handle.stop(), "the gateway or runner thread did not stop"
            assert not handle.runner.is_alive(), "the runner thread outlived stop()"
        log(f"gateway {backend} (c): 2 streams dropped and cancelled, 4 "
            f"finished, pool balanced, a fresh request ended length")
        torch.cuda.synchronize()
        del eng
        torch.cuda.empty_cache()
    return launches


def gateway_phase(smi):
    """Phase 9: ``camformer-bert`` at full width behind the HTTP/SSE
    gateway on ``camformer`` and ``dense``; returns each run's launches."""
    return [gateway_backend(backend, smi)
            for backend in ("camformer", "dense")]


# ---------------------------------------------------------------------------
# phase 10: the encoder-decoder and Griffin hybrid families

# whisper-medium: 4 rows of 1500 stub frames, 32-token prompts, a
# 448-token decoder cache (Whisper's text context), 64 greedy steps;
# recurrentgemma-2b: 4 rows of 2016-token prompts, cache_len 2080 (a
# 2048-slot ring), 64 greedy steps (positions 2048-2079 overwrite slots
# 0-31)
WHISPER_B, WHISPER_PROMPT, WHISPER_CACHE, WHISPER_DECODE = 4, 32, 448, 64
RG_B, RG_PROMPT, RG_CACHE, RG_DECODE = 4, 2016, 2080, 64
RG_ROW = "bacam_mvm (recurrentgemma prefill)"
WHISPER_ENC_ROW = "bacam_mvm (whisper encoder)"
WHISPER_DEC_ROW = "bacam_mvm (whisper decoder prefill)"
WHISPER_XPRE_ROW = "bacam_mvm (whisper cross-attention prefill)"
WHISPER_XDEC_ROW = "bacam_mvm (whisper cross-attention decode)"
LLAVA_ROW = "bacam_mvm (llava prefill)"
WHISPER_SHARE_ROW = "bacam_mvm (whisper encoder share, model 4)"
# phase 17's train batches, rows x text tokens: whisper-medium 8 x 448
# (Whisper's text context; the encoder reads 8 x 1500 stub frames) and
# recurrentgemma-2b 2 x 2048 (its attention window)
WHISPER_TRAIN_B, WHISPER_TRAIN_S = 8, 448
RG_TRAIN_B, RG_TRAIN_S = 2, 2048
WHISPER_ENC_TRAIN_ROW = "bacam_mvm (whisper encoder, train)"
WHISPER_DEC_TRAIN_ROW = "bacam_mvm (whisper decoder self-attention, train)"
WHISPER_X_TRAIN_ROW = "bacam_mvm (whisper cross-attention, train)"
RG_TRAIN_ROW = "bacam_mvm (recurrentgemma attention, train)"
# (B * H_kv, R, Skv, W) of kernel 4 there: recurrentgemma's prefill (MQA,
# G = 10 rows of each position, head_dim 256); whisper's non-causal
# encoder, its decoder's causal prefill, and its cross-attention to the
# 1500 frames at prefill and at every decode step (16 heads, head_dim 64);
# and phase 7's llava prefill (2 rows x 8 kv heads, G = 4 rows of each of
# the 896 positions, head_dim 128)
FAMILY_MVM_SHAPES = {
    RG_ROW: (RG_B, 10 * RG_PROMPT, RG_PROMPT, 8),
    WHISPER_ENC_ROW: (WHISPER_B * 16, 1500, 1500, 2),
    WHISPER_DEC_ROW: (WHISPER_B * 16, WHISPER_PROMPT, WHISPER_PROMPT, 2),
    WHISPER_XPRE_ROW: (WHISPER_B * 16, WHISPER_PROMPT, 1500, 2),
    WHISPER_XDEC_ROW: (WHISPER_B * 16, 1, 1500, 2),
    LLAVA_ROW: (VLM_B * 8, 4 * (VLM_PATCHES + VLM_TEXT),
                VLM_PATCHES + VLM_TEXT, 4),
    # phase 14: a rank's share of whisper's encoder at model = 4, B = 2
    WHISPER_SHARE_ROW: (2 * 16 // 4, 1500, 1500, 2),
    # phase 17's train steps (forward and recompute): whisper's encoder,
    # its decoder's causal self-attention and its cross-attention to the
    # 1500 frames; recurrentgemma's attention (MQA, G = 10 folded, causal
    # within the window)
    WHISPER_ENC_TRAIN_ROW: (WHISPER_TRAIN_B * 16, 1500, 1500, 2),
    WHISPER_DEC_TRAIN_ROW: (WHISPER_TRAIN_B * 16, WHISPER_TRAIN_S,
                            WHISPER_TRAIN_S, 2),
    WHISPER_X_TRAIN_ROW: (WHISPER_TRAIN_B * 16, WHISPER_TRAIN_S, 1500, 2),
    RG_TRAIN_ROW: (RG_TRAIN_B, 10 * RG_TRAIN_S, RG_TRAIN_S, 8)}
FAMILY_MVM_PATHS = {
    RG_ROW: "phase 10: recurrentgemma-2b camformer use_kernel prefill (one "
            "launch an attention layer)",
    WHISPER_ENC_ROW: "phase 10: whisper-medium camformer use_kernel encoder "
                     "(one launch a layer)",
    WHISPER_DEC_ROW: "phase 10: whisper-medium camformer use_kernel decoder "
                     "prefill (one launch a layer)",
    WHISPER_XPRE_ROW: "phase 10: whisper-medium camformer use_kernel "
                      "cross-attention at prefill (one launch a layer)",
    WHISPER_XDEC_ROW: "phase 10: whisper-medium camformer use_kernel "
                      "cross-attention at each decode step (one launch a "
                      "layer a step)",
    LLAVA_ROW: "phase 7: llava-next-mistral-7b camformer use_kernel "
               "whole-prompt prefill (one launch a layer)",
    WHISPER_SHARE_ROW: "phase 14: each of the 4 ranks' share of a "
                       "whisper-medium encoder layer (4 of 16 heads, "
                       "B = 2), forward",
    WHISPER_ENC_TRAIN_ROW: "phase 17: whisper-medium camformer use_kernel "
                           "train step, encoder (forward and recompute, "
                           "every layer)",
    WHISPER_DEC_TRAIN_ROW: "phase 17: whisper-medium camformer use_kernel "
                           "train step, decoder self-attention (forward "
                           "and recompute, every layer)",
    WHISPER_X_TRAIN_ROW: "phase 17: whisper-medium camformer use_kernel "
                         "train step, cross-attention (forward and "
                         "recompute, every layer)",
    RG_TRAIN_ROW: "phase 17: recurrentgemma-2b camformer use_kernel train "
                  "step (forward and recompute, every attention layer)"}
# the W = 8 rows' plain version runs over slices of RG_CHECK_ROWS rows
RG_CHECK_ROWS = 2016


def families_kernel_phase(flush):
    """Kernel 4 at every shape phases 7, 10, 14 and 17 launch it at,
    bit-exact against its plain version and timed beside it, its bound and
    ``torch.bmm`` of the ±1 bf16 operands with float32 output (4-byte
    scores, as the function writes): recurrentgemma-2b's prefill (4,
    20160, 2016), W = 8; whisper-medium's encoder (64, 1500, 1500), whose
    1500 keys are no multiple of a group or a key tile, its decoder
    prefill (64, 32, 32), and its cross-attention (64, 32, 1500) at
    prefill and (64, 1, 1500) at each decode step, W = 2; llava's prefill
    (16, 3584, 896), W = 4; phase 17's train steps: whisper's encoder
    (128, 1500, 1500), decoder self-attention (128, 448, 448) and
    cross-attention (128, 448, 1500), W = 2, and recurrentgemma's
    attention (2, 20480, 2048), W = 8.  Then the source's designs timed
    apart (``mvm_design_phase``).  The plain version's int64 temporaries
    at (4, 20160, 2016) would take about 10 GB each, so at W = 8 it runs
    over slices of RG_CHECK_ROWS rows: the check covers every row, and
    plain_ms is the time of those slices in turn.
    Then kernel 3 at whisper's decode step, checked and timed (logged)."""
    from repro_torch.core.bacam import unpack_bits
    from repro_torch.kernels import bacam_mvm as bmvm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    rows = []
    for name, (bh, r, skv, w) in FAMILY_MVM_SHAPES.items():
        d = 32 * w
        q, k = (torch.randint(-2**31, 2**31 - 1, (bh, n, w), generator=gen,
                              device=dev, dtype=torch.int32)
                for n in (r, skv))
        got = bmvm.bacam_mvm(q, k, d=d)
        step = RG_CHECK_ROWS if w == 8 else r

        def plain(out=None):
            out = torch.empty_like(got) if out is None else out
            for r0 in range(0, r, step):
                out[:, r0:r0 + step] = bmvm.bacam_scores_ref(
                    q[:, r0:r0 + step], k, d)
            return out

        want = plain()
        torch.cuda.synchronize()
        assert torch.equal(got, want), \
            f"{name}: kernel 4 differs from its plain version"
        del want
        if name in (WHISPER_ENC_ROW, WHISPER_ENC_TRAIN_ROW):
            hold_last_group(got[:, :32])
        qf, kf = (unpack_bits(x, d).to(torch.bfloat16) for x in (q, k))
        library = lambda: torch.bmm(qf, kf.transpose(1, 2),
                                    out_dtype=torch.float32)
        assert torch.equal(library().to(torch.int32), got), \
            f"{name}: f32-output bmm yardstick is not exact"
        outputs = bh * r * skv
        scratch = torch.empty_like(got)
        rows.append(dict(
            name=name, route="cuda", path=FAMILY_MVM_PATHS[name],
            source="src/repro_torch/csrc/bacam_mvm.cu",
            replaces="src/repro/kernels/bacam_mvm.py:62", max_abs_err=0.0,
            ms=cuda_ms(lambda: bmvm.bacam_mvm(q, k, d=d), flush=flush),
            plain_ms=cuda_ms(lambda: plain(scratch), flush=flush, n=5,
                             warmup=1),
            # packed operands read once, int32 scores written once; xor,
            # popc and add per word of each score
            **bound((bh * r + bh * skv) * w * 4 + outputs * 4,
                    3 * w * outputs / INT32_OP_PER_S),
            library_ms=cuda_ms(library, flush=flush)))
        log(f"{name} ({bh}, {r}, {skv}) W={w}: bit-exact"
            f"{f' (checked {step} rows a call)' if step < r else ''}; "
            f"kernel {rows[-1]['ms']:.6g} ms, plain "
            f"{rows[-1]['plain_ms']:.6g} ms, f32-output bmm "
            f"{rows[-1]['library_ms']:.6g} ms, bound "
            f"{rows[-1]['bound_ms']:.6g} ms")
        del got, qf, kf, q, k, scratch
        torch.cuda.empty_cache()
    mvm_design_phase(gen, flush)
    whisper_decode_topk(gen, flush)
    return rows


# kernel 4's designs timed apart at one shape of each W on a path (W = 2:
# the train step, whisper's encoder, its cross-attention at prefill and at
# a decode step; W = 4: llava's prefill; W = 8: recurrentgemma's prefill),
# and at whisper's encoder with 1504 keys (6016-byte rows, 47 whole
# 128-byte lines) beside its 1500 (6000-byte rows)
MVM_DESIGN_SHAPES = ((128, 1024, 1024, 2), (64, 1500, 1500, 2),
                     (64, 1500, 1504, 2), (64, 32, 1500, 2),
                     (64, 1, 1500, 2), (16, 3584, 896, 4),
                     (4, 20160, 2016, 8))


def mvm_design_phase(gen, flush):
    """Each design of ``csrc/bacam_mvm.cu`` (``bacam_mvm.launch``, counted
    nowhere) at ``MVM_DESIGN_SHAPES``: every design's scores equal the
    popc design's (itself held to the plain version in the kernel rows at
    the path shapes), then CUDA-event times (L2 flushed) beside the
    shape's byte bound and the design the source picks.  Logged on a line
    of its own; the source's design switch is read from these times."""
    from repro_torch.kernels import bacam_mvm as bmvm

    dev = torch.device("cuda")
    popc = bmvm.DESIGNS.index("popc")
    out = []
    for bh, r, skv, w in MVM_DESIGN_SHAPES:
        d = 32 * w
        q, k = (torch.randint(-2**31, 2**31 - 1, (bh, n, w), generator=gen,
                              device=dev, dtype=torch.int32)
                for n in (r, skv))
        want = bmvm.launch(q, k, d=d, design=popc)
        row = dict(shape=[bh, r, skv, w],
                   picked=bmvm.DESIGNS[bmvm.plan(r, w)],
                   bound_ms=bound((bh * r + bh * skv) * w * 4
                                  + bh * r * skv * 4, 0)["bound_ms"])
        for design, name in enumerate(bmvm.DESIGNS):
            got = bmvm.launch(q, k, d=d, design=design)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{name} at {row['shape']}"
            del got
            row[name] = cuda_ms(
                lambda: bmvm.launch(q, k, d=d, design=design), flush=flush)
        out.append(row)
        del q, k, want
        torch.cuda.empty_cache()
    log(f"bacam_mvm designs (ms; CUDA events, L2 flushed): {json.dumps(out)}")
    return out


def whisper_decode_topk(gen, flush):
    """Kernel 3 at whisper-medium's decode step, bit-exact against its
    plain version: 64 (b, head) rows of R = 1 against a 448-slot cache (no
    multiple of the 128-key tile), kv_len ragged over the rows (the last
    slot, one short of it, and two inside), q_pos = kv_len - 1; timed
    beside its plain version and its bound (logged: the row
    ``bacam_topk_stage1`` is timed at camformer-bert's decode step)."""
    from repro_torch.kernels import bacam_topk as btk

    dev = torch.device("cuda")
    bh, w, cache = WHISPER_B * 16, 2, WHISPER_CACHE
    kv_len = torch.tensor([cache, cache - 1, WHISPER_PROMPT + 1, 321],
                          dtype=torch.int32, device=dev).repeat_interleave(16)
    q, k = (torch.randint(-2**31, 2**31 - 1, (bh, n, w), generator=gen,
                          device=dev, dtype=torch.int32) for n in (1, cache))
    q_pos = (kv_len - 1)[:, None].contiguous()
    kw = dict(d=32 * w, causal=True, group=16, stage1_k=2)
    got = btk.bacam_topk_stage1(q, k, q_pos, kv_len, **kw)
    want = btk.bacam_topk_stage1_plain(q, k, q_pos, kv_len, **kw)
    n_valid, n_dead = check_candidates("bacam_topk_stage1 whisper decode",
                                       got, want, 16, 2)
    ms = cuda_ms(lambda: btk.bacam_topk_stage1(q, k, q_pos, kv_len, **kw),
                 flush=flush)
    plain_ms = cuda_ms(lambda: btk.bacam_topk_stage1_plain(
        q, k, q_pos, kv_len, **kw), flush=flush)
    live = int(kv_len.sum())
    b = bound(q.numel() * 4 + live * w * 4 + 2 * bh * 4
              + 2 * got[0].numel() * 4, 3 * w * live / INT32_OP_PER_S)
    log(f"bacam_topk_stage1 whisper decode ({bh} x 1 rows, {cache} keys, "
        f"kv_len {kv_len[::16].tolist()}): bit-exact ({n_valid} valid "
        f"candidates, {n_dead} fully masked groups); kernel {ms:.6g} ms, "
        f"plain {plain_ms:.6g} ms, bound {b['bound_ms']:.6g} ms by "
        f"{b['bound_by']}")


def hold_last_group(scores, group=16, stage1_k=2, k_top=32):
    """The two-stage top-k over 1500 keys (93 full groups of 16 and a
    last group of 12, padded with NEG_INF) on the card equals the CPU's,
    values and indices, on kernel 4's scores of 32 query rows whose last
    group is raised above every other score (so it must be selected)."""
    from repro_torch.core.topk import two_stage_topk

    s = scores.float()
    n = s.shape[-1]
    s[..., n - n % group:] += 200.0
    card = two_stage_topk(s, k=k_top, group_size=group, stage1_k=stage1_k)
    cpu = two_stage_topk(s.cpu(), k=k_top, group_size=group,
                         stage1_k=stage1_k)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)), \
        "two-stage top-k over 1500 keys: card differs from the CPU"
    assert bool((card[1][..., :stage1_k] >= n - n % group).all()), \
        "the last, partial group's candidates were not selected"
    log(f"two-stage top-k over {n} keys ({n // group} groups of {group} "
        f"and one of {n % group}): card equals CPU, the last group's "
        f"{stage1_k} candidates first in every row")


def family_batch(cfg, b, prompt, dev, seed=SEED):
    """Seeded prompts (and, for whisper, stub frame embeddings of unit
    scale) on ``dev``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     (b, prompt)))}
    if cfg.enc_len:
        batch["audio_features"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_len, cfg.d_model)).astype(np.float32))
    return {k: v.to(dev) for k, v in batch.items()}


def card_cpu_decode(cfg, params, batch, steps, cache_len):
    """Prefill ``batch`` and decode ``steps`` greedy steps on the CPU and
    on the card from the same parameters, both fed the CPU's picks.
    Returns ({device: stacked logits}, {device: final caches}) on the
    host."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import cast_params, get_model_def, init_pools

    md = get_model_def(cfg)
    prefill, serve = make_prefill_step(md, cfg), make_serve_step(md, cfg)
    b, s = batch["tokens"].shape
    logits, caches_out, fed = {}, {}, []
    for devname in ("cpu", "cuda"):
        dev = torch.device(devname)
        p = cast_params(params, torch.float32, dev)
        caches = init_pools(md.cache_specs(cfg, b, cache_len), dev)
        lg, caches = prefill(p, {k: v.to(dev) for k, v in batch.items()},
                             caches)
        rows = [lg]
        pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        for step in range(steps):
            if devname == "cpu":
                fed.append(torch.argmax(rows[-1], -1))
            lg, caches = serve(p, fed[step].to(dev), pos, pos + 1, caches)
            rows.append(lg)
            pos = pos + 1
        logits[devname] = torch.stack(rows).cpu()
        caches_out[devname] = caches
    return logits, caches_out


def card_cpu_train(cfg, params, batch):
    """One train step's loss and gradients on the card against the CPU:
    (loss error, loss within 1e-5, largest gradient error, every
    gradient within 1e-4, the card's loss)."""
    from repro_torch.launch.steps import make_value_and_grad
    from repro_torch.models import cast_params, get_model_def
    from repro_torch.models.module import tree_leaves

    def grads(dev):
        loss, _, g = make_value_and_grad(get_model_def(cfg), cfg)(
            cast_params(params, torch.float32, dev),
            {k: v.to(dev) for k, v in batch.items()})
        return loss.cpu(), [t.cpu() for t in tree_leaves(g)]

    (l_card, g_card), (l_cpu, g_cpu) = grads("cuda"), grads("cpu")
    e_loss, ok_loss = close(l_card, l_cpu, 1e-5)
    e_grad = max(close(a, c, 1e-4)[0] for a, c in zip(g_card, g_cpu))
    ok_grad = all(close(a, c, 1e-4)[1] for a, c in zip(g_card, g_cpu))
    return e_loss, ok_loss, e_grad, ok_grad, l_card


def families_parity_phase():
    """At f32 smoke width, card against CPU: whisper-medium (2 encoder +
    2 decoder layers) and recurrentgemma-2b (8 layers: two periods and
    both trailing rec layers, window 16 so the ring wraps), on ``dense``
    and on ``camformer`` with ``use_kernel``: prefill of 24 tokens + 8
    decode steps, both fed the CPU's greedy picks, logits within 1e-4
    and the card's picks equal; then one train step's loss (1e-5) and
    gradients (1e-4) on ``camformer`` with ``use_kernel``."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params

    out = {}
    for arch, kw in (("whisper-medium", {}),
                     ("recurrentgemma-2b", dict(n_layers=8, window=16))):
        for backend, use_kernel in (("dense", False), ("camformer", True)):
            cfg = smoke_config(arch, attn_backend=backend,
                               use_kernel=use_kernel, **kw)
            params = init_params(cfg, device="cpu", seed=SEED)
            b, s, steps = 3, 24, 8
            logits, _ = card_cpu_decode(cfg, params,
                                        family_batch(cfg, b, s, "cpu"),
                                        steps, s + steps)
            err, ok = close(logits["cuda"], logits["cpu"], 1e-4)
            assert ok, f"family parity {arch} {backend}: max abs err {err}"
            assert torch.equal(logits["cuda"].argmax(-1),
                               logits["cpu"].argmax(-1)), (arch, backend)
            out[f"{arch} {backend}"] = err
        cfg = smoke_config(arch, attn_backend="camformer", use_kernel=True,
                           **kw)
        params = init_params(cfg, device="cpu", seed=SEED)
        batch = family_batch(cfg, 2, 32, "cpu", seed=SEED + 1)
        batch["labels"] = torch.roll(batch["tokens"], -1, 1)
        e_loss, ok_loss, e_grad, ok_grad, l_card = card_cpu_train(
            cfg, params, batch)
        assert torch.isfinite(l_card) and ok_loss and ok_grad, \
            f"family train parity {arch}: loss {e_loss} grad {e_grad}"
        out[f"{arch} train"] = dict(loss=e_loss, grad=e_grad)
    log(f"family parity smoke, card vs CPU max abs err: {json.dumps(out)} "
        f"(tol 1e-4 logits, greedy picks identical; train 1e-5 loss, "
        f"1e-4 gradients)")
    return out


def family_run(arch, backend, *, b, prompt, cache_len, steps,
               probe_step=None):
    """One family at full width and depth in bf16 (seeded random
    weights) through ``make_prefill_step`` / ``make_serve_step``:
    prefill, then ``steps`` greedy decode steps, launches counted and
    plain versions on the card refused; 8 more steps profiled after.
    Returns the readings, the launches at prefill and in all.

    With ``probe_step`` (a state O(1) in the sequence) the decode steps'
    own peak is read apart, after ``probe_step`` steps and after all of
    them, and must not grow beyond ``STATE_SLACK_BYTES``.

    Memory: ``live_at_entry_gb`` is what earlier phases still hold when
    the run starts, ``freed_by_gc_gb`` the part of it that only reference
    cycles kept (``gc.collect()`` frees it before the run); the peak is
    read over prefill and decode after ``empty_cache`` and
    ``reset_peak_memory_stats``, as allocated (``peak_mem_gb``, live
    tensors) and reserved (``peak_reserved_gb``, the allocator's cached
    blocks too), from ``live_at_start_gb`` (the weights, the caches and
    what is left of earlier phases)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import (cast_params, count_params,
                                    get_model_def, init_params, init_pools)

    live_at_entry_gb = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    freed_by_gc_gb = live_at_entry_gb - torch.cuda.memory_allocated() / 1e9
    cfg = get_config(arch, attn_backend=backend,
                     use_kernel=backend == "camformer")
    md = get_model_def(cfg)
    params = cast_params(init_params(cfg, device="cuda", seed=SEED),
                         torch.bfloat16)
    n_params = count_params(params)
    batch = family_batch(cfg, b, prompt, "cuda")
    prefill, serve = make_prefill_step(md, cfg), make_serve_step(md, cfg)
    readings = dict(arch=arch, backend=backend, batch=b, prompt=prompt,
                    cache_len=cache_len, decode_steps=steps, params=n_params)
    if cfg.enc_len:  # the encoder alone, timed apart (not counted)
        from repro_torch.models.encdec import encode

        encode(params, batch["audio_features"], cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode(params, batch["audio_features"], cfg)
        torch.cuda.synchronize()
        readings["encoder_s"] = time.perf_counter() - t0
    caches = init_pools(md.cache_specs(cfg, b, cache_len), "cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    readings.update(live_at_entry_gb=live_at_entry_gb,
                    freed_by_gc_gb=freed_by_gc_gb,
                    live_at_start_gb=torch.cuda.memory_allocated() / 1e9)
    with plain_calls_on_card() as plain:
        reset_launches()
        t0 = time.perf_counter()
        logits, caches = prefill(params, batch, caches)
        torch.cuda.synchronize()
        readings["prefill_s"] = time.perf_counter() - t0
        at_prefill = read_launches(families=True)
        if probe_step:  # the decode steps' peak, apart from the prefill's
            prefill_peak = (torch.cuda.max_memory_allocated(),
                            torch.cuda.max_memory_reserved())
            torch.cuda.reset_peak_memory_stats()
        pos = torch.full((b,), prompt, dtype=torch.int32, device="cuda")
        picks = []
        t0 = time.perf_counter()
        for i in range(steps):
            tok = torch.argmax(logits, -1)
            picks.append(tok)
            logits, caches = serve(params, tok, pos, pos + 1, caches)
            pos = pos + 1
            if i + 1 == probe_step:  # the allocator counts on the host
                peak_at_probe = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches = read_launches(families=True)
        if probe_step:
            decode_peak = torch.cuda.max_memory_allocated()
            readings.update(
                decode_peak_gb_at_probe=peak_at_probe / 1e9,
                decode_peak_gb_at_end=decode_peak / 1e9,
                prefill_peak_gb=prefill_peak[0] / 1e9)
            assert decode_peak <= peak_at_probe + STATE_SLACK_BYTES, \
                f"{arch}: decode memory grew {peak_at_probe} -> " \
                f"{decode_peak} bytes from step {probe_step} to {steps}"
        assert torch.isfinite(logits).all(), f"{arch} {backend}: non-finite"
        picks = torch.stack(picks)
        assert bool(((picks >= 0) & (picks < cfg.vocab)).all())
        if "attn_pos" in caches:  # the ring wrapped: slot p mod wlen
            wlen = caches["attn_pos"].shape[1]
            last = prompt + steps - 1
            assert int(caches["attn_pos"][0, last % wlen]) == last
            assert int(caches["attn_pos"].max()) == last
        state = dict(logits=logits, caches=caches, pos=pos - 8)

        def run():  # 8 more steps, rewriting the last 8 positions
            for _ in range(8):
                state["logits"], state["caches"] = serve(
                    params, torch.argmax(state["logits"], -1), state["pos"],
                    state["pos"] + 1, state["caches"])
                state["pos"] = state["pos"] + 1

        peaks = (torch.cuda.max_memory_allocated(),
                 torch.cuda.max_memory_reserved())
        if probe_step:
            peaks = (max(peaks[0], prefill_peak[0]),
                     max(peaks[1], prefill_peak[1]))
        readings.update(
            decode_s=decode_s, decode_tokens_per_s=b * steps / decode_s,
            peak_mem_gb=peaks[0] / 1e9, peak_reserved_gb=peaks[1] / 1e9,
            plain_calls_on_card=sum(plain.values()))
        readings["profile_decode_8_steps"] = profiled(run)
    assert plain == {}, f"{arch} {backend}: plain versions on the card " \
        f"{plain}"
    if "encoder_s" in readings:
        readings["decoder_prefill_s"] = (readings["prefill_s"]
                                         - readings["encoder_s"])
    readings["launches"] = {k: v for k, v in launches.items() if v}
    log(f"family {arch}/{backend} full width bf16: {json.dumps(readings)}")
    del params, caches, state, logits
    torch.cuda.empty_cache()
    return at_prefill, launches


def families_phase():
    """Phase 10: card-vs-CPU parity at smoke width, then whisper-medium
    and recurrentgemma-2b at full width and depth in bf16 on
    ``camformer`` (use_kernel: exact launch counts) and ``dense`` (no
    kernel).  Returns the runs' launches."""
    families_parity_phase()
    runs = []
    n_dec, n_enc = 24, 24  # whisper-medium's decoder and encoder layers
    for backend in ("camformer", "dense"):
        at_prefill, launches = family_run(
            "whisper-medium", backend, b=WHISPER_B, prompt=WHISPER_PROMPT,
            cache_len=WHISPER_CACHE, steps=WHISPER_DECODE)
        # per layer: kernel 4 at the encoder, the decoder prefill and the
        # cross-attention at prefill and at every step; kernel 3 at every
        # decoder self-attention step
        want = {WHISPER_ENC_ROW: n_enc, WHISPER_DEC_ROW: n_dec,
                WHISPER_XPRE_ROW: n_dec,
                WHISPER_XDEC_ROW: n_dec * WHISPER_DECODE,
                "bacam_topk_stage1": n_dec * WHISPER_DECODE}
        if backend == "dense":
            want = {}
        assert {k: v for k, v in launches.items() if v} == want, launches
        assert at_prefill[WHISPER_XDEC_ROW] == 0, at_prefill
        assert at_prefill["bacam_topk_stage1"] == 0, at_prefill
        runs.append(launches)
    n_attn = 8  # recurrentgemma-2b: 8 periods of (rec, rec, attn) + 2
    for backend in ("camformer", "dense"):
        _, launches = family_run(
            "recurrentgemma-2b", backend, b=RG_B, prompt=RG_PROMPT,
            cache_len=RG_CACHE, steps=RG_DECODE)
        want = n_attn if backend == "camformer" else 0
        assert launches[RG_ROW] == want, launches
        assert all(v == 0 for k, v in launches.items() if k != RG_ROW), \
            launches  # the ring decode takes the plain CAM search
        runs.append(launches)
    return runs


# ---------------------------------------------------------------------------
# phase 11: the ssm family (rwkv6-3b) and the BA-CAM device model

# rwkv6-3b: 4 prompts of 512 tokens, then 64 greedy steps; the decode
# peak after 8 steps bounds the rest, the state being O(1)
RWKV_B, RWKV_PROMPT, RWKV_DECODE, RWKV_PROBE = 4, 512, 64, 8
# the picks kept (512 B each after the allocator's rounding) and one
# 2 MiB allocator block
STATE_SLACK_BYTES = 2 * 2**20
# the device model at camformer-bert's head geometry (one 64-bit tile)
DM_SHAPE = (1, 16, 1024, 64)
DM_KEY = (0, 42)  # a raw key: two uint32 words
DM_SIGMA, DM_BITS = 0.014, 6
# the normals' bound, card against CPU: log1p is CUDA's on one side and
# the C library's on the other, each within an ulp or two of the true
# value (tests/test_torch_bacam_device.py reasons the bound)
NORMAL_ULP = 4
ADC_BOUNDARY = 1e-5  # match counts this close to a boundary may differ


def rwkv_parity_phase():
    """Phase 11 (a): ``rwkv6-3b`` at f32 smoke width (2 layers, two heads
    of 64), card against CPU: prefill of 24 tokens and 8 greedy steps,
    both fed the CPU's picks, logits within 1e-4 and picks equal, the
    carried shifts and WKV state within 1e-4; a train step (remat): loss
    1e-5, gradients 1e-4; no kernel launched."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params

    cfg = smoke_config("rwkv6-3b", d_model=128, remat="full")
    params = init_params(cfg, device="cpu", seed=SEED)
    with plain_calls_on_card() as plain:
        reset_launches()
        logits, caches = card_cpu_decode(
            cfg, params, family_batch(cfg, 3, 24, "cpu"), 8, 32)
        batch = family_batch(cfg, 2, 32, "cpu", seed=SEED + 1)
        batch["labels"] = torch.roll(batch["tokens"], -1, 1)
        e_loss, ok_loss, e_grad, ok_grad, l_card = card_cpu_train(
            cfg, params, batch)
        launches = read_launches()
    err, ok = close(logits["cuda"], logits["cpu"], 1e-4)
    assert ok, f"rwkv6 parity: logits max abs err {err}"
    assert torch.equal(logits["cuda"].argmax(-1), logits["cpu"].argmax(-1))
    state = {}
    for name, want in caches["cpu"].items():
        state[name], ok = close(caches["cuda"][name].cpu(), want, 1e-4)
        assert ok, f"rwkv6 parity: state {name} max abs err {state[name]}"
    assert torch.isfinite(l_card) and ok_loss and ok_grad, \
        f"rwkv6 train parity: loss {e_loss} grad {e_grad}"
    assert plain == {} and not any(launches.values()), (plain, launches)
    out = dict(logits=err, state=state, train=dict(loss=e_loss, grad=e_grad))
    log(f"rwkv6 parity smoke, card vs CPU max abs err: {json.dumps(out)} "
        f"(tol 1e-4 logits and state, greedy picks identical; train 1e-5 "
        f"loss, 1e-4 gradients; no kernel launched)")
    return launches


def rwkv_phase():
    """Phase 11 (b): ``rwkv6-3b`` at full width and depth in bf16 through
    the contiguous steps: no kernel, no plain version on the card, finite
    logits, the decode peak flat from step ``RWKV_PROBE``."""
    _, launches = family_run(
        "rwkv6-3b", "dense", b=RWKV_B, prompt=RWKV_PROMPT,
        cache_len=RWKV_PROMPT + RWKV_DECODE, steps=RWKV_DECODE,
        probe_step=RWKV_PROBE)
    assert not any(launches.values()), launches
    return launches


def near_adc_boundary(m, bits=DM_BITS, cam_w=64):
    """Elements of the noisy match counts ``m`` within ADC_BOUNDARY of a
    rounding boundary of the ``bits`` ADC."""
    t = m.double() * ((1 << bits) - 1) / cam_w
    return (t - t.floor() - 0.5).abs() * cam_w / ((1 << bits) - 1) \
        < ADC_BOUNDARY


def device_model_phase():
    """Phase 11 (c): the BA-CAM device model on the card against the CPU
    at camformer-bert's head geometry (``DM_SHAPE``, one 64-bit tile),
    the 6-bit ADC with 1.4% matchline noise under a fixed raw key: the
    threefry bits identical, the normals within ``NORMAL_ULP``, the ADC
    scores equal away from its rounding boundaries, ``attention`` in
    ``camformer`` mode within 1e-4 on every row without such a score
    (with ``use_kernel``: no kernel launched, no plain version on the
    card); at d 256 (4 tiles) 7-bit scores equal to the exact integer
    path; then, a reading, the top-32 recall of the noisy 6-bit scores
    against the exact ones; last, ``examples/torch_quickstart.py`` on
    the card in a subprocess."""
    import os

    from repro_torch.core import (AttentionSpec, attention, bacam,
                                  single_stage_topk, topk_recall)
    from repro_torch.core.binarize import binarize_qk, sign_pm1
    from repro_torch.serving import prng

    b, h, s, d = DM_SHAPE
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.from_numpy(rng.standard_normal(DM_SHAPE).astype(
        np.float32)) for _ in range(3))
    key = torch.tensor(DM_KEY, dtype=torch.int64)
    noise_shape = (b, h, 1, s, s, d // 64)  # (B, H_kv, G, Sq, Skv, T)
    n = math.prod(noise_shape)
    assert torch.equal(prng.random_bits(key.cuda(), n).cpu(),
                       prng.random_bits(key, n)), "threefry bits differ"
    scale = DM_SIGMA * 64
    noise = prng.normal(key, noise_shape, scale=scale)
    ulp = (noise.view(torch.int32).long() - prng.normal(
        key.cuda(), noise_shape, scale=scale).cpu().view(torch.int32).long()
           ).abs()
    assert int(ulp.max()) <= NORMAL_ULP, f"normals {int(ulp.max())} ulp"
    qb, kb, _, _ = binarize_qk(q.reshape(b, h, 1, s, d), k, with_scales=True)
    kb = kb[:, :, None]
    kw = dict(exact=False, adc_bits=DM_BITS, noise_sigma=DM_SIGMA)
    want = bacam.bacam_scores(qb, kb, rng=key, **kw)
    got = bacam.bacam_scores(qb.cuda(), kb.cuda(), rng=key.cuda(), **kw).cpu()
    exact = bacam.binary_scores_exact(qb, kb)
    near = near_adc_boundary(((exact[..., None] + 64) * 0.5 + noise).clamp(
        0, 64))[..., 0]
    assert torch.equal(got[~near], want[~near]), "ADC scores differ"
    spec = AttentionSpec(mode="camformer", adc_bits=DM_BITS,
                         noise_sigma=DM_SIGMA)
    want_out = attention(q, k, v, spec, rng=key)
    on_card = [t.cuda() for t in (q, k, v)]
    card_spec = spec.replace(use_kernel=True)
    with plain_calls_on_card() as plain:
        reset_launches()
        got_out = attention(*on_card, card_spec, rng=key.cuda()).cpu()
        launches = read_launches()
    assert plain == {} and not any(launches.values()), (plain, launches)
    rows = ~near.reshape(b, h, s, s).any(-1)
    out_err, ok = close(got_out[rows], want_out[rows], 1e-4)
    assert ok, f"device-model attention: max abs err {out_err}"
    card_ms = cuda_ms(lambda: attention(*on_card, card_spec,
                                        rng=key.cuda()), n=5, warmup=1)
    q4, k4 = (sign_pm1(torch.from_numpy(rng.standard_normal(
        (h, 512, 256)).astype(np.float32))).cuda() for _ in range(2))
    tiled = bacam.bacam_scores(q4, k4, exact=False, adc_bits=7)
    assert torch.equal(tiled, bacam.bacam_scores(q4, k4).float()), \
        "d 256: 7-bit scores differ from the exact integer path"
    exact_card = exact.cuda()
    recall = topk_recall(single_stage_topk(got.cuda(), 32)[1],
                         single_stage_topk(exact_card, 32)[1])
    readings = dict(
        shape=list(DM_SHAPE), noise_elements=n,
        normals_differing=int((ulp > 0).sum()), normals_max_ulp=int(ulp.max()),
        scores_near_boundary=int(near.sum()),
        scores_differing=int((got != want).sum()),
        attention_rows_checked=int(rows.sum()), attention_max_abs_err=out_err,
        attention_card_ms=card_ms,
        mean_abs_score_error=float((got - exact).abs().mean()),
        top32_recall_vs_exact=float(recall.mean()))
    log(f"device model card vs CPU (6-bit ADC, sigma 1.4%, camformer-bert "
        f"heads): {json.dumps(readings)}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable,
                           str(ROOT / "examples" / "torch_quickstart.py")],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    for line in proc.stdout.strip().splitlines():
        log(f"  torch_quickstart: {line}")
    log(f"torch_quickstart on the card: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def ssm_device_phase():
    """Phase 11: rwkv6-3b card against CPU and at full width, then the
    device model.  Returns the runs' launches (none)."""
    runs, took = [], {}
    for name, part in (("a", rwkv_parity_phase), ("b", rwkv_phase),
                       ("c", device_model_phase)):
        t0 = time.perf_counter()
        runs.append(part())
        took[name] = time.perf_counter() - t0
    log(f"phase 11 parts, s: {json.dumps(took)}")
    return runs


# ---------------------------------------------------------------------------
# phase 12: distribution at a world of one

DIST_STEPS = 4  # phase 8's first steps, retraced through the sharded step
DIST_DECODE_PROMPT, DIST_DECODE_STEPS = 512, 8


@contextlib.contextmanager
def nccl_world_of_one():
    """A real NCCL process group of one process (a file rendezvous under
    the checkout's ``build/``, no TCP port) and its (1, 1) ``("data",
    "model")`` mesh, installed as the ambient mesh; destroyed on exit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (init_distributed, make_mesh_for,
                                         set_mesh)

    store = ROOT / "build" / "nccl_rendezvous"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)  # a stale store would hold old keys
    init_distributed("cuda", init_method=f"file://{store}", rank=0,
                     world_size=1)
    try:
        mesh = make_mesh_for(1, 1)
        set_mesh(mesh)
        yield mesh
    finally:
        set_mesh(None)
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def sharded_train_phase(mesh, smi):
    """Phase 12 (a) and (b): camformer-bert at full width and depth
    through ``Trainer(mesh=)`` (the sharded step: DTensor blocks, rows
    over the batch axes, gradients reduced and clipped by the global norm)
    for DIST_STEPS steps of phase 8's schedule and seeds: its losses
    within 1e-6 relative of phase 8's first DIST_STEPS, kernel 4 exactly
    2 x 24 x DIST_STEPS times, no plain version on the card; then its
    checkpoint (written at step DIST_STEPS by process 0) restored through
    ``rescale_state`` onto the mesh, ``verify_rescale`` true."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch.elastic import rescale_state, verify_rescale
    from repro_torch.models import get_model_def
    from repro_torch.models.attention import attn_strategy
    from repro_torch.sharding import partitioning as P
    from repro_torch.train.data import SyntheticLMData
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("camformer-bert", attn_backend="camformer",
                     use_kernel=True)
    md = get_model_def(cfg)
    ckpt = ROOT / "build" / "dist_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        data = SyntheticLMData(cfg, TRAIN_SHAPE, seed=SEED, device="cuda",
                               mesh=mesh)
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=DIST_STEPS,
                             ckpt_dir=str(ckpt), keep=1, log_every=1,
                             warmup=2, seed=SEED)
        trainer = Trainer(md, cfg, data, tcfg, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        P.SPLIT_SEEN.clear()
        with plain_calls_on_card() as plain:
            reset_launches()
            t0 = time.perf_counter()
            state = trainer.run(until=DIST_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        assert plain == {}, f"sharded train: plain on the card {plain}"
        assert launches["bacam_mvm"] == 2 * cfg.n_layers * DIST_STEPS, \
            launches
        assert only_bacam_mvm(launches), launches
        # the model-axis split's code ran, on whole blocks at model = 1
        seen = dict(P.SPLIT_SEEN)
        assert seen == dict(attn_q_heads=cfg.n_heads,
                            attn_kv_heads=cfg.n_kv_heads, mlp_cols=cfg.d_ff,
                            vocab_rows=cfg.padded_vocab,
                            res_rows=TRAIN_S), seen
        losses = [r["loss"] for r in trainer.metrics_log]
        ref = TRAIN_LINES["camformer"]
        want = ref["losses"][:DIST_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        assert len(losses) == DIST_STEPS and max(rel) <= 1e-6, \
            (losses, want)
        t1 = time.perf_counter()
        restored, at = rescale_state(str(ckpt), md, cfg, mesh)
        same = verify_rescale(state, restored)
        assert at == DIST_STEPS and same, (at, same)
        rescale_s = time.perf_counter() - t1
        del state, restored
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    step_s = statistics.median(r["step_time_s"] for r in trainer.metrics_log)
    line = dict(card=smi, steps=DIST_STEPS, losses=losses,
                phase8_losses=want, max_rel_loss_diff=max(rel),
                median_step_s=step_s,
                phase8_median_step_s=ref["median_step_s"],
                step_ratio=step_s / ref["median_step_s"], wall_s=wall,
                peak_mem_gb=peak, phase8_peak_mem_gb=ref["peak_mem_gb"],
                kernel4_launches=launches["bacam_mvm"],
                model_split=dict(strategy=attn_strategy(cfg, 1),
                                 local_extents=seen),
                rescale=dict(step=at, bit_identical=same,
                             save_restore_verify_s=rescale_s))
    log("phase 12 sharded train camformer-bert camformer use_kernel bf16 "
        f"full width, NCCL world of one, mesh (1, 1): {json.dumps(line)}")
    return {TRAIN_ROW: launches["bacam_mvm"]}


def distributed_decode_phase(mesh):
    """Phase 12 (c): a B = 1 camformer decode of full-width camformer-bert
    with ``distributed_topk`` under the group and the ambient mesh
    (``use_kernel``; a prompt of DIST_DECODE_PROMPT tokens, then
    DIST_DECODE_STEPS greedy steps) equals the flag-off decode bit for
    bit: at a world of one no axis shards the cache, and the search is
    the local one.  Returns the launches of both runs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import (cast_params, get_model_def, init_params,
                                    init_pools)

    base = get_config("camformer-bert", attn_backend="camformer",
                      use_kernel=True)
    params = cast_params(init_params(base, device="cuda", seed=SEED),
                         torch.bfloat16)
    rng = np.random.default_rng(SEED + 12)
    prompt = torch.from_numpy(rng.integers(
        0, base.vocab, (1, DIST_DECODE_PROMPT)).astype(np.int32)).cuda()
    cache_len = DIST_DECODE_PROMPT + DIST_DECODE_STEPS
    logits, runs = {}, []
    for flag in (True, False):
        cfg = base.replace(distributed_topk=flag)
        md = get_model_def(cfg)
        caches = init_pools(md.cache_specs(cfg, 1, cache_len), "cuda")
        prefill, serve = make_prefill_step(md, cfg), make_serve_step(md, cfg)
        with plain_calls_on_card() as plain:
            reset_launches()
            out, caches = prefill(params, {"tokens": prompt}, caches)
            seen = [out]
            for t in range(DIST_DECODE_STEPS):
                pos = torch.full((1,), DIST_DECODE_PROMPT + t,
                                 dtype=torch.int32, device="cuda")
                tok = out.argmax(-1).to(torch.int32)
                out, caches = serve(params, tok, pos, pos + 1, caches)
                seen.append(out)
            torch.cuda.synchronize()
            runs.append(read_launches())
        assert plain == {}, plain
        logits[flag] = torch.stack(seen).cpu()
    assert torch.isfinite(logits[True]).all()
    assert torch.equal(logits[True], logits[False]), \
        "distributed_topk decode differs from the flag-off decode"
    assert runs[0] == runs[1], runs
    log(f"phase 12 distributed_topk decode camformer-bert B = 1 "
        f"({DIST_DECODE_PROMPT} + {DIST_DECODE_STEPS} steps): equal to the "
        f"flag-off decode bit for bit; launches {json.dumps(runs[0])}")
    return runs


# phase 12's families: (arch, backend, depth overrides, B, tokens)
DIST_FAMILIES = (("whisper-medium", "camformer",
                  dict(enc_layers=2, n_layers=2), 2, 64),
                 ("recurrentgemma-2b", "camformer", dict(n_layers=3), 2, 512),
                 ("rwkv6-3b", "dense", dict(n_layers=2), 2, 256))
DIST_FAMILY_STEPS = 2


def sharded_families_phase(mesh):
    """Phase 12 (d): whisper-medium (2 + 2 layers), recurrentgemma-2b (one
    period) and rwkv6-3b (2 blocks) at full width in bf16 (f32 masters,
    remat), DIST_FAMILY_STEPS steps through the unsharded step and
    through the sharded step on the NCCL group of one (the ``model``
    split's code on whole blocks, identity collectives): the losses bit
    for bit equal, the split regions run on every head, rnn channel and
    MLP column, kernel 4 launched exactly as often by both (2 an
    attention layer a step on camformer), no plain version on the card.
    Returns the launches."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models import get_model_def
    from repro_torch.sharding import partitioning as P
    from repro_torch.train.data import SyntheticLMData

    runs, lines = [], {}
    for arch, backend, over, b, s in DIST_FAMILIES:
        cfg = get_config(arch, attn_backend=backend,
                         use_kernel=backend == "camformer", **over)
        md = get_model_def(cfg)
        SHAPES["phase12_family"] = dict(seq_len=s, global_batch=b,
                                        kind="train")
        got = {}
        for m in (None, mesh):
            data = SyntheticLMData(cfg, "phase12_family", seed=SEED,
                                   device="cuda", mesh=m)
            step, opt = make_train_step(md, cfg, warmup=1, mesh=m)
            state = init_state(cfg, opt, seed=SEED, device="cuda", mesh=m)
            P.SPLIT_SEEN.clear()
            with plain_calls_on_card() as plain:
                reset_launches()
                losses = []
                for i in range(DIST_FAMILY_STEPS):
                    state, metrics = step(state, data.batch(i))
                    losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                launches = read_launches()
            assert plain == {}, (arch, plain)
            runs.append(launches)
            got[m is None] = (losses, launches["bacam_mvm"],
                              dict(P.SPLIT_SEEN))
            del state
            torch.cuda.empty_cache()
        attn = (cfg.enc_layers + 2 * cfg.n_layers if arch == "whisper-medium"
                else cfg.n_layers // 3 if arch == "recurrentgemma-2b" else 0)
        want4 = 2 * attn * DIST_FAMILY_STEPS if backend == "camformer" else 0
        assert got[True][1] == got[False][1] == want4, (arch, got)
        assert all(math.isfinite(x) for x in got[True][0]), got
        assert got[False][0] == got[True][0], \
            (arch, "sharded losses differ from the unsharded step's", got)
        assert got[True][2] == {} and got[False][2], got
        lines[f"{arch}/{backend}"] = dict(
            losses=got[False][0], unsharded_losses=got[True][0],
            kernel4_launches=got[False][1], local_extents=got[False][2])
    log(f"phase 12 sharded families, NCCL world of one, model = 1, bf16: "
        f"{json.dumps(lines)}")
    return runs


def distribution_phase(smi):
    """Phase 12: a world-one NCCL group, the sharded train step with
    elastic restore, and the distributed CAM search under it."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    with nccl_world_of_one() as mesh:
        backend = dist.get_backend()
        runs = [sharded_train_phase(mesh, smi)]
        distributed_decode_phase(mesh)  # its launches: logged, not rows
        runs += sharded_families_phase(mesh)
        runs.append(sharded_serving_phase(mesh, smi))
    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    log(f"phase 12: backend {backend}, NCCL {nccl}, "
        f"{time.perf_counter() - t0:.1f} s")
    assert backend == "nccl", backend
    return runs


def sharded_serving_phase(mesh, smi):
    """Phase 15 (a): phase 6 (a)'s camformer-bert run (full width and
    depth, bf16, ``use_kernel``: 8 x 896-token prompts, whole-prompt
    prefill, greedy steps) through ``make_prefill_step(mesh=)`` /
    ``make_serve_step(mesh=)`` on the world-one mesh (1, 1): DTensor
    blocks of the weights (``serve_params``) and caches
    (``init_caches``), the batch's rows (``local_rows``), logits back as
    DTensor blocks, and the split code at size 1 inside
    ``model_split``.  Cut to SERVE_SPLIT_STEPS steps: the prefill logits
    and every step's logits and picks bit-identical to phase 6's; kernel
    4 exactly once a layer, kernel 3 once a layer a step; no plain
    version on the card.  Returns its launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models import cast_params, get_model_def, init_params

    t0 = time.perf_counter()
    cfg = get_config("camformer-bert", use_kernel=True)
    md = get_model_def(cfg)
    n_layers, b = cfg.n_layers, CONTIG_B
    params = S.serve_params(cast_params(
        init_params(cfg, device="cuda", seed=SEED), torch.bfloat16), md,
        cfg, mesh)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (b, CONTIG_PROMPT))).to("cuda")
    caches = S.init_caches(md, cfg, b, CONTIG_CACHE, mesh, device="cuda")
    prefill = S.make_prefill_step(md, cfg, mesh=mesh)
    serve = S.make_serve_step(md, cfg, mesh=mesh)
    rec = CONTIG_RECORD
    reset_launches()
    with plain_calls_on_card() as plain:
        logits, caches = prefill(params, S.local_rows({"tokens": tokens},
                                                      mesh, b), caches)
        assert torch.equal(logits.full_tensor(), rec["prefill"]), \
            "sharded prefill logits differ from phase 6 (a)'s"
        pos = torch.full((b,), CONTIG_PROMPT, dtype=torch.int32,
                         device="cuda")
        for step in range(SERVE_SPLIT_STEPS):
            tok = torch.argmax(logits.full_tensor(), -1)
            logits, caches = serve(params, tok, pos, pos + 1, caches)
            assert torch.equal(logits.full_tensor(), rec["logits"][step]), \
                f"sharded decode step {step} differs from phase 6 (a)'s"
            pos = pos + 1
        torch.cuda.synchronize()
    launches = read_launches()
    assert plain == {}, plain
    want = {"bacam_mvm": n_layers,
            "bacam_topk_stage1": n_layers * SERVE_SPLIT_STEPS}
    assert {k: v for k, v in launches.items() if v} == want, launches
    log(f"phase 15 (a) sharded prefill + serve steps, mesh (1, 1) "
        f"({smi}): " + json.dumps(dict(
            arch="camformer-bert", batch=b, prompt=CONTIG_PROMPT,
            cache_len=CONTIG_CACHE, decode_steps=SERVE_SPLIT_STEPS,
            logits_equal_phase_6=True,
            logits_placements=[str(pl) for pl in logits.placements],
            launches=want, seconds=time.perf_counter() - t0)))
    del caches, params, logits
    CONTIG_RECORD.clear()
    torch.cuda.empty_cache()
    return launches


# phase 13: each rank's share of a head-sharded tick, in one process

TP_CASES = (("camformer-bert", "camformer", (2, 4)),
            ("camformer-bert", "dense", (2, 4)),
            ("camformer-bert", "binary", (2, 4)),
            ("camformer-bert", "hybrid", (2, 4)),
            ("granite-moe-3b-a800m", "camformer", (2, 4, 8)),
            ("granite-moe-3b-a800m", "dense", (2, 4, 8)))


def recorded_layer_calls(arch, backend):
    """One layer of ``arch`` at full width (depth cut to 1), bf16, served
    by a tp = 1 ``ServeEngine`` with phase 5's geometry (8 slots, 1024
    tokens, 64-token pages, sync mode) for the slice's 8 prompts and 4
    new tokens: the layer's ``paged_decode`` inputs (its pools copied
    before the call) at the 384-row prefill chunk and at the last decode
    tick."""
    from repro_torch.configs import get_config
    from repro_torch.core.backend import get_backend
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine

    cfg = get_config(arch, attn_backend=backend, n_layers=1)
    bk = get_backend(backend)
    eng = ServeEngine(cfg, init_params(cfg, device="cuda", seed=SEED),
                      max_batch=8, max_len=1024, page_size=64, mode="sync",
                      device="cuda")
    calls = {}

    def record(q, cache, k, v, positions, table, kv_len, cfg_, *, base=None):
        kind = "decode" if q.shape[2] == 1 else f"chunk{q.shape[2]}"
        calls[kind] = (q.clone(), {n: t.clone() for n, t in cache.items()},
                       k.clone(), v.clone(), positions.clone(),
                       table.clone(), kv_len.clone(),
                       None if base is None else base.clone(), cfg_)
        return type(bk).paged_decode(bk, q, cache, k, v, positions, table,
                                     kv_len, cfg_, base=base)

    bk.paged_decode = record
    try:
        for _ in eng.stream(*slice_requests(cfg.vocab, SEED, max_new=4)):
            pass
    finally:
        del bk.paged_decode
    assert eng.tick_errors == 0, eng.last_error
    chunk = f"chunk{max(SLICE_LENS)}"
    assert set(calls) == {chunk, "decode"}, sorted(calls)
    del eng
    return bk, cfg, {"prefill chunk": calls[chunk], "decode": calls["decode"]}


def tp_share_phase(smi):
    """Phase 13: for each case of TP_CASES, at each tp degree, each rank's
    ``tp_local_decode`` on its ``slice_pools`` slice, run in turn in this
    process on the recorded prefill chunk and decode tick: the outputs
    concatenated in rank order equal the tp = 1 call's bit for bit, each
    rank's written pool slice equals the tp = 1 pool's head slice bit
    for bit (but the trash page 0, where every padding row lands in the
    scatter's order) and holds 1/tp of its bytes, the ranks launch exactly tp
    times what the tp = 1 call launches, and no plain version runs on
    the card.  Returns the ranks' launches."""
    from repro_torch.models.attention import tp_local_decode
    from repro_torch.serving import sharded

    t0 = time.perf_counter()
    runs, lines = [], {}
    for arch, backend, degrees in TP_CASES:
        bk, cfg, calls = recorded_layer_calls(arch, backend)
        for kind, (q, pools, k, v, pos, table, kv_len, base,
                   cfg_) in calls.items():
            copy = lambda: {n: t.clone() for n, t in pools.items()}
            with plain_calls_on_card() as plain:
                reset_launches()
                out, whole = bk.paged_decode(q, copy(), k, v, pos, table,
                                             kv_len, cfg_, base=base)
                torch.cuda.synchronize()
                one = read_launches()
                bytes_1 = sharded.pool_bytes([whole])
                for tp in degrees:
                    reset_launches()
                    outs, ranks_bytes = [], []
                    for r in range(tp):
                        mine = sharded.slice_pools([pools], r, tp)[0]
                        o, mine = tp_local_decode(bk, q, mine, k, v, pos,
                                                  table, kv_len, cfg_, base,
                                                  r, tp)
                        want = sharded.slice_pools([whole], r, tp)[0]
                        for n in want:  # page 0 is the trash page
                            a, b = ((mine[n][1:], want[n][1:])
                                    if n.endswith("_pages")
                                    else (mine[n], want[n]))
                            assert torch.equal(a, b), \
                                (arch, backend, kind, tp, r, n)
                        ranks_bytes.append(sharded.pool_bytes([mine]))
                        outs.append(o)
                    torch.cuda.synchronize()
                    got = read_launches()
                    runs.append(got)
                    assert torch.equal(torch.cat(outs, dim=1), out), \
                        (arch, backend, kind, tp)
                    assert all(b * tp == bytes_1 for b in ranks_bytes), \
                        (bytes_1, ranks_bytes)
                    assert got == {n: tp * c for n, c in one.items()}, \
                        (arch, backend, kind, tp, one, got)
                    lines[f"{arch}/{backend} {kind} tp={tp}"] = dict(
                        pool_bytes_tp1=bytes_1, pool_bytes_a_rank=ranks_bytes,
                        launches={n: c for n, c in got.items() if c})
            assert plain == {}, (arch, backend, kind, plain)
        del calls
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 13 tp shares, one process, each rank's share = tp = 1 bit "
        f"for bit ({smi}): {json.dumps(lines)}")
    log(f"phase 13: {seconds:.1f} s")
    return runs


# phase 14: each rank's share of a split training block, in one process

# (arch, backends, config overrides: the depth cut to one block, f32)
SHARE_BLOCKS = (("whisper-medium", ("camformer", "dense"),
                 dict(enc_layers=1, n_layers=1)),
                ("recurrentgemma-2b", ("camformer", "dense"),
                 dict(n_layers=3)),
                ("rwkv6-3b", ("dense",), dict(n_layers=1)))
SHARE_DEGREES = (2, 4)
SHARE_B, SHARE_FRAMES, SHARE_TOKENS = 2, 1500, 64  # whisper
SHARE_RG_S, SHARE_RWKV_S = 512, 256
# kernel 4's launches of the unsplit block (m = 1) and of each degree's
# shares: one an attention layer a rank (recurrentgemma at m = 4: 10 q
# heads do not divide, every rank runs the whole attention, kv_seq)
SHARE_LAUNCHES = {
    ("whisper-medium", "camformer", 1): {"bacam_mvm": 3},
    ("whisper-medium", "camformer", 2): {"bacam_mvm": 6},
    ("whisper-medium", "camformer", 4): {"bacam_mvm": 8,
                                         WHISPER_SHARE_ROW: 4},
    ("recurrentgemma-2b", "camformer", 1): {"bacam_mvm": 1},
    ("recurrentgemma-2b", "camformer", 2): {"bacam_mvm": 2},
    ("recurrentgemma-2b", "camformer", 4): {"bacam_mvm": 4}}


def share_block(arch, cfg):
    """(block function of (params, *inputs) -> outputs, its inputs, the
    names of the outputs) of one split training block of ``arch`` at
    full width: whisper's encoder layer feeding its decoder layer as the
    memory, recurrentgemma's (rec, rec, attn) period, rwkv6's block."""
    from repro_torch.models import encdec, rglru, rwkv6
    from repro_torch.models.transformer import arange_positions

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    d, b = cfg.d_model, SHARE_B
    if arch == "whisper-medium":
        pe = arange_positions(b, SHARE_FRAMES, "cuda")
        pd = arange_positions(b, SHARE_TOKENS, "cuda")

        def fn(p, feats, x):
            mem = encdec._enc_block(p["enc_blocks"][0], feats, cfg, pe)
            y, _ = encdec._dec_block(p["dec_blocks"][0], x, cfg, mem, None,
                                     pd, None, None)
            return mem, y

        return fn, [randn(b, SHARE_FRAMES, d), randn(b, SHARE_TOKENS, d)], (
            "encoder layer", "decoder layer")
    if arch == "recurrentgemma-2b":
        pos = arange_positions(b, SHARE_RG_S, "cuda")

        def fn(p, x):
            zero = lambda: {n: torch.zeros(shape, dtype=dt, device="cuda")
                            for n, (shape, dt) in
                            rglru._rec_state_spec(cfg, b).items()}
            y, _ = rglru._period(p["rec1"][0], p["rec2"][0], p["attn"][0], x,
                                 cfg, zero(), zero(), None, pos, None, None,
                                 None, True)
            return (y,)

        return fn, [randn(b, SHARE_RG_S, d)], ("period",)
    h, c = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim

    def fn(p, x):
        zero = lambda *shape: torch.zeros(shape, device="cuda")
        return (rwkv6._apply_block(p["blocks"][0], x, cfg, zero(b, d),
                                   zero(b, d), zero(b, h, c, c))[0],)

    return fn, [randn(b, SHARE_RWKV_S, d)], ("block",)


@contextlib.contextmanager
def held_projections(cfg):
    """On a backend that binarizes Q and K (camformer): record the
    unsplit run's Q/K/V (``attention._project``) and its rotated Q and K
    (``attention.rope``) call by call; in a share, compare the share's
    Q and K signs, before and after the rotation (the signs binarized),
    with the unsplit run's block of that rank (a sign that differs is a
    flip: a GEMM over a column slice, or a split region upstream, may
    round otherwise than the unsplit code, and a component near zero
    may change sign in the rotation only), and with ``hold`` set of
    ("proj" | "rope", rank, call) substitute the recorded values, the
    gradient still flowing into the share's own projections.  Yields the
    state dict (no flip on other backends)."""
    from repro_torch.models import attention
    from repro_torch.sharding import partitioning as P

    orig, orig_rope = attention._project, attention.rope
    st = dict(whole=[], whole_rope=[], calls={}, flips={}, hold=set())
    if cfg.backend != "camformer":
        yield st
        return

    def count(kind, rank):
        i = st["calls"][kind, rank] = st["calls"].get((kind, rank), -1) + 1
        return kind, rank, i

    def project(p, x, cfg_, split=False, seq=False, cross_kv=None,
                q_rows=False, q_cols=False):
        q, k, v = orig(p, x, cfg_, split, seq, cross_kv, q_rows=q_rows,
                       q_cols=q_cols)
        at = P.split_rank()
        if at is None:
            st["whole"].append((q.detach(), k.detach(), v.detach()))
            return q, k, v
        key = count("proj", at[0])
        wq, wk, _ = st["whole"][key[2]]
        ref_q, ref_k = rank_block(wq, q, at[0]), rank_block(wk, k, at[0])
        st["flips"][key] = int(((q > 0) != (ref_q > 0)).sum()
                               + ((k > 0) != (ref_k > 0)).sum())
        if key in st["hold"]:
            q = ref_q + (q - q.detach())
            k = ref_k + (k - k.detach())
        return q, k, v

    def rope(x, positions, theta):
        out = orig_rope(x, positions, theta)
        at = P.split_rank()
        if at is None:
            st["whole_rope"].append(out.detach())
            return out
        key = count("rope", at[0])
        ref = rank_block(st["whole_rope"][key[2]], out, at[0])
        st["flips"][key] = int(((out > 0) != (ref > 0)).sum())
        if key in st["hold"]:
            out = ref + (out - out.detach())
        return out

    attention._project, attention.rope = project, rope
    try:
        yield st
    finally:
        attention._project, attention.rope = orig, orig_rope


def rank_block(whole, part, rank):
    """``rank``'s block of the unsplit run's tensor ``whole`` (B, heads,
    S, D) where a share's ``part`` holds fewer heads (``heads``,
    ``qheads``) or query rows (``q_seq``): the dims that differ, cut at
    ``rank`` times the part's extent."""
    for d, (n, m) in enumerate(zip(whole.shape, part.shape)):
        if m < n:
            whole = whole.narrow(d, rank * m, m)
    return whole


@contextlib.contextmanager
def kernel4_held():
    """Every launch of kernel 4 held against its plain version on the
    same inputs (the plain version called directly, outside the count of
    plain calls on the card); yields [launches checked, mismatches]."""
    from repro_torch.kernels import bacam_mvm as bmvm

    orig, plain = bmvm.bacam_mvm, bmvm.bacam_scores_ref
    seen = [0, 0]

    def checked(q, k, *, d, **kw):
        out = orig(q, k, d=d, **kw)
        seen[0] += 1
        seen[1] += int(not torch.equal(out, plain(q, k, d)))
        return out

    bmvm.bacam_mvm = checked
    try:
        yield seen
    finally:
        bmvm.bacam_mvm = orig


def share_run(fn, params, inputs, cot_seed, shares=None):
    """(outputs, whole-leaf gradients by path, input gradients) of one
    forward and backward of ``fn``: whole, or with ``shares`` = (dims, m)
    as each rank's share in turn (``run_shares``; a ``"split"`` leaf's
    block gradients land in the whole leaf, a ``"partial"`` leaf's parts
    are summed there)."""
    from repro_torch.launch.steps import share_params
    from repro_torch.models.module import tree_map
    from repro_torch.sharding import partitioning as P

    live = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    xs = [x.clone().requires_grad_() for x in inputs]
    if shares is None:
        outs = fn(live, *xs)
    else:
        dims, m = shares
        outs = P.run_shares(lambda r: fn(share_params(live, dims, r, m),
                                         *xs), m)[0]
    gen = torch.Generator(device="cuda").manual_seed(cot_seed)
    loss = sum((o * torch.randn(o.shape, generator=gen, device="cuda")).sum()
               for o in outs)
    loss.backward()
    torch.cuda.synchronize()
    return ([o.detach() for o in outs], tree_map(lambda t: t.grad, live),
            [x.grad for x in xs])


def share_errors(got, want, plan):
    """Largest errors of a share run against the unsplit one: outputs
    relative to max |out|, gradients relative to max(1, max |g|) of the
    leaf, by the plan's kind (inputs apart; the leaves outside the block
    have none)."""
    from repro_torch.launch.steps import map_specs

    errs = {"outputs": max(float((a - b).abs().max() / b.abs().max())
                           for a, b in zip(got[0], want[0]))}
    rel = lambda a, b: float((a - b).abs().max()) / max(
        1.0, float(b.abs().max()))
    for_kind = {}

    def leaf(g, w, how):  # leaves outside the block have no gradient
        assert (g is None) == (w is None), how
        if w is not None:
            for_kind.setdefault(how, []).append(rel(g, w))

    map_specs(leaf, got[1], want[1], plan)
    for how, e in for_kind.items():
        errs[f"{how} grads"] = max(e)
    errs["input grads"] = max(rel(a, b) for a, b in zip(got[2], want[2]))
    return errs


SHARE_TOL = {"outputs": 1e-5, "split grads": 1e-4, "partial grads": 1e-4,
             "whole grads": 1e-4, "input grads": 1e-4}


def share_phase(smi):
    """Phase 14: for each block of SHARE_BLOCKS at full width (f32, the
    depth cut to one block) and each backend, one forward and backward
    unsplit, then at each degree of SHARE_DEGREES every rank's share in
    turn in this process (``partitioning.run_shares``: no process group,
    the collectives exchanged in process): the outputs within 1e-5 of
    max |out| of the unsplit block's, every gradient within 1e-4 (the
    ``"split"`` leaves' blocks and the summed ``"partial"`` leaves
    against the whole's), each kernel-4 launch bit-exact against its
    plain version, the binarized Q/K signs that flip against the unsplit
    run's heads counted (a share with a flip is held on the recorded
    projections and run again), exact kernel-4 launches and no plain
    version on the card.  Returns the counting passes' launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import model_shares
    from repro_torch.models import get_model_def, init_params
    from repro_torch.sharding import partitioning as P

    t0 = time.perf_counter()
    runs, lines = [], {}
    for arch, backends, over in SHARE_BLOCKS:
        for backend in backends:
            cfg = get_config(arch, attn_backend=backend, dtype="float32",
                             use_kernel=backend == "camformer", **over)
            md = get_model_def(cfg)
            params = init_params(cfg, device="cuda", seed=SEED)
            fn, inputs, names = share_block(arch, cfg)
            # kernel 4's checks call its plain version outside the count
            with held_projections(cfg) as held, kernel4_held() as k4, \
                    plain_calls_on_card() as plain:
                reset_launches()
                whole = share_run(fn, params, inputs, SEED)
                one = read_launches(families=True)
                runs.append(one)
                assert ({n: c for n, c in one.items() if c}
                        == SHARE_LAUNCHES.get((arch, backend, 1), {})), one
                for m in SHARE_DEGREES:
                    plan, dims = model_shares(md, cfg, m)
                    held["calls"].clear()
                    held["hold"].clear()
                    held["flips"].clear()
                    P.SPLIT_SEEN.clear()
                    reset_launches()
                    got = share_run(fn, params, inputs, SEED, (dims, m))
                    launches = read_launches(families=True)
                    runs.append(launches)
                    assert ({n: c for n, c in launches.items() if c}
                            == SHARE_LAUNCHES.get((arch, backend, m), {})), \
                        (arch, backend, m, launches)
                    seen = dict(P.SPLIT_SEEN)
                    flips = dict(held["flips"])
                    held_shares = sorted({r for (_, r, _), n in
                                          flips.items() if n})
                    if held_shares:  # again, flipped calls held
                        held["hold"] = {key for key, n in flips.items() if n}
                        held["calls"].clear()
                        reset_launches()
                        got = share_run(fn, params, inputs, SEED, (dims, m))
                        assert read_launches(families=True) == launches
                    errs = share_errors(got, whole, plan)
                    bad = {k: e for k, e in errs.items()
                           if not e <= SHARE_TOL[k]}
                    assert not bad, (arch, backend, m, errs)
                    lines[f"{arch}/{backend} m={m}"] = dict(
                        errors=errs, local_extents=seen,
                        flips=sum(flips.values()), held_ranks=held_shares,
                        launches={n: c for n, c in launches.items() if c},
                        unsplit_launches={n: c for n, c in one.items()
                                          if c})
                assert plain == {}, (arch, backend, plain)
                assert k4[1] == 0, f"kernel 4 differs from its plain " \
                                   f"version in {k4[1]} of {k4[0]} launches"
                lines[f"{arch}/{backend} kernel 4 held"] = k4[0]
            del params, whole, got
            torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 14 model-split shares, one process, f32 full width "
        f"({smi}): {json.dumps(lines)}")
    log(f"phase 14: {seconds:.1f} s")
    return runs


# phase 15 (b): every rank's share of the sharded serving steps, in one
# process: (arch, backends, depth overrides, model degrees); B = 2
# prompts of 512 tokens in a 576-slot cache (a multiple of 4 x the
# 16-key group: each shard of a sequence-split cache holds whole groups)
SERVE_SHARE_CASES = (("camformer-bert", ("camformer",), dict(n_layers=2),
                      (2, 4)),
                     ("recurrentgemma-2b", ("camformer", "dense"),
                      dict(n_layers=3), (2, 4)))
SERVE_SHARE_B, SERVE_SHARE_PROMPT = 2, 512
SERVE_SHARE_CACHE, SERVE_SHARE_STEPS = 576, 8


def serve_share_run(md, cfg, params, tokens, m=None):
    """(logits of the prefill and each step, the greedy picks, launches)
    of the contiguous prefill and SERVE_SHARE_STEPS greedy steps: whole,
    or with ``m`` every rank's share of the sharded steps in turn
    (``serve_shares``; each step's shares' logits joined along the
    vocabulary where it splits)."""
    from repro_torch.launch import steps as S

    b = tokens.shape[0]
    caches = S.init_caches(md, cfg, b, SERVE_SHARE_CACHE, device="cuda")
    if m is None:
        prefill, serve = S.make_prefill_step(md, cfg), \
            S.make_serve_step(md, cfg)
        call = lambda kind, args: (prefill(params, *args, caches)
                                   if kind == "prefill"
                                   else serve(params, *args, caches))[0]
    else:
        def call(kind, args):
            outs = S.serve_shares(md, cfg, kind, params, args, caches, m)
            return torch.cat(outs, -1) if outs[0].shape[-1] < \
                cfg.padded_vocab else outs[0]
    reset_launches()
    with torch.no_grad():
        out = [call("prefill", ({"tokens": tokens},))]
        picks = []
        for step in range(SERVE_SHARE_STEPS):
            pos = torch.full((b,), SERVE_SHARE_PROMPT + step,
                             dtype=torch.int32, device="cuda")
            picks.append(out[-1].argmax(-1).to(torch.int32))
            out.append(call("decode", (picks[-1], pos, pos + 1)))
    torch.cuda.synchronize()
    from repro_torch.kernels import bacam_mvm

    return out, picks, read_launches(families=True), \
        dict(bacam_mvm.shape_launches)


def serve_share_phase(smi):
    """Phase 15 (b): for each case of SERVE_SHARE_CASES at full width
    (f32, the depth cut), the unsplit contiguous prefill and greedy
    steps, then at each degree every rank's share of the sharded steps
    in turn in this process (``launch.steps.serve_shares``): every
    step's logits within 1e-5 of max |logits| of the unsplit run's, the
    picks identical, kernel 4 once an attention layer a rank at prefill
    and bit-exact against its plain version on every launch, kernel 3
    (camformer-bert, whose heads split) once a layer a step a rank, the
    binarized Q/K signs that flip against the unsplit run counted (a run
    with a flip is held on the recorded projections and run again), no
    plain version on the card.  camformer-bert splits its heads;
    recurrentgemma-2b (10 q heads on one kv head) runs ``qheads`` at 2
    and ``q_seq`` at 4, its ring's sequence split over ``model`` at
    both.  Returns the counting runs' launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model_def, init_params
    from repro_torch.sharding import partitioning as P

    t0 = time.perf_counter()
    runs, lines = [], {}
    for arch, backends, over, degrees in SERVE_SHARE_CASES:
        for backend in backends:
            cfg = get_config(arch, attn_backend=backend, dtype="float32",
                             use_kernel=backend == "camformer", **over)
            md = get_model_def(cfg)
            params = init_params(cfg, device="cuda", seed=SEED)
            tokens = torch.from_numpy(np.random.default_rng(SEED + 15)
                                      .integers(0, cfg.vocab, (
                                          SERVE_SHARE_B, SERVE_SHARE_PROMPT))
                                      .astype(np.int32)).cuda()
            # attention layers: every layer, or the period's one
            n_attn = 1 if arch == "recurrentgemma-2b" else cfg.n_layers
            kernel3 = arch == "camformer-bert" and backend == "camformer"
            with held_projections(cfg) as held, kernel4_held() as k4, \
                    plain_calls_on_card() as plain:
                want, want_picks, one, shapes = serve_share_run(
                    md, cfg, params, tokens)
                runs.append(one)
                k4_shapes = collections.Counter(shapes)
                for m in (1,) + degrees:
                    if m > 1:
                        held["calls"].clear()
                        held["hold"].clear()
                        held["flips"].clear()
                        P.SPLIT_SEEN.clear()
                        got, picks, launches, shapes = serve_share_run(
                            md, cfg, params, tokens, m)
                        runs.append(launches)
                        k4_shapes.update(shapes)
                    else:
                        launches = one
                    k4_want = n_attn * m if backend == "camformer" else 0
                    live = {n: c for n, c in launches.items() if c}
                    assert live == {k: v for k, v in {
                        "bacam_mvm": k4_want,
                        "bacam_topk_stage1": n_attn * SERVE_SHARE_STEPS * m
                        if kernel3 else 0}.items() if v}, (arch, m, live)
                    if m == 1:
                        continue
                    seen = dict(P.SPLIT_SEEN)
                    flips = dict(held["flips"])
                    if any(flips.values()):  # again, flipped calls held
                        held["hold"] = {key for key, n in flips.items()
                                        if n}
                        held["calls"].clear()
                        got, picks, again, _ = serve_share_run(
                            md, cfg, params, tokens, m)
                        assert again == launches, (again, launches)
                    errs = [float((g - w).abs().max() / w.abs().max())
                            for g, w in zip(got, want)]
                    assert max(errs) <= 1e-5, (arch, backend, m, errs)
                    assert all(torch.equal(a, b)
                               for a, b in zip(picks, want_picks)), \
                        (arch, backend, m)
                    lines[f"{arch}/{backend} m={m}"] = dict(
                        max_rel_err=max(errs), local_extents=seen,
                        flips=sum(flips.values()),
                        held_ranks=sorted({r for (_, r, _), n in
                                           flips.items() if n}),
                        launches=live)
                assert plain == {}, (arch, backend, plain)
                assert k4[1] == 0, f"kernel 4 differs from its plain " \
                                   f"version in {k4[1]} of {k4[0]} launches"
                lines[f"{arch}/{backend} kernel 4 held"] = k4[0]
            # kernel 4's launches by (B, R, Skv, W), the unsplit and
            # the counting share runs
            lines[f"{arch}/{backend} kernel 4 shapes"] = {
                str(k): v for k, v in k4_shapes.items()}
            del params, want, got
            torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 15 (b) sharded serving shares, one process, f32 full width "
        f"({smi}): {json.dumps(lines)}")
    log(f"phase 15: {seconds:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 16: the assigned decoder LMs at full width and depth

# smallest risk first; llava-next-mistral-7b serves text-only (its 32
# layers), as the reference serves the VLM
ASSIGNED_ARCHS = ("codeqwen1.5-7b", "mistral-nemo-12b",
                  "llava-next-mistral-7b", "moonshot-v1-16b-a3b", "yi-34b")
ASSIGNED_D = 128  # the head_dim of every one of them
# the kernels whose launches phase 16 counts in the rows of its geometries
GEOMETRY_KERNELS = ("bacam_paged_topk_stage1", "paged_flash_decode",
                    "paged_flash_decode (sq>1)")


def assigned_phase():
    """Each of ``ASSIGNED_ARCHS`` at full width and depth, seeded random
    bf16 weights drawn at that dtype, served on ``camformer`` (kernel 1)
    and ``dense`` (kernels 2 and 2b) as ``python -m
    repro_torch.launch.serve --arch <arch> --backend <backend>
    --max-batch 8 --max-len 1024`` builds it, one engine at a time, with
    ``serve_run``'s checks and exact launch counts.  What earlier phases
    left to the cycle collector is collected first (and printed); each
    engine is then freed without it.  Returns each run's launches, counted
    in the rows of the arch's geometry (``geometry_row``)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    live = torch.cuda.memory_allocated()
    gc.collect()
    log(f"phase 16 entry: {live / 1e9:.6g} GB live, "
        f"{(live - torch.cuda.memory_allocated()) / 1e9:.6g} GB of it freed "
        f"by gc.collect()")
    runs = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        for backend in ("camformer", "dense"):
            _, launches, _, _ = serve_run(backend, arch=arch)
            runs.append({geometry_row(k, hkv, g) if k in GEOMETRY_KERNELS
                         else k: v for k, v in launches.items()})
            log(f"phase 16 elapsed {time.perf_counter() - t0:.1f}s: "
                f"{arch}/{backend}")
    return runs


# ---------------------------------------------------------------------------
# phase 17: four families trained at full width and depth

# (arch, backends, rows, text tokens, steps, peak lr): each batch is
# train_4k (256 x 4096) cut to what one card holds; whisper-medium's
# camformer run ends in a checkpoint that a second Trainer resumes for
# FAMILY_RESUME_STEPS.  whisper's 48 layers overshoot at the Trainer's
# default 3e-4 (and at 2.5e-4, Whisper medium's published peak) after a
# 2-step warmup: step 3's loss jumps, and step 4's can end above step
# 1's; at 1e-4 it ends below on both backends
FAMILY_TRAIN = (
    ("whisper-medium", ("camformer", "dense"), WHISPER_TRAIN_B,
     WHISPER_TRAIN_S, 4, 1e-4),
    ("recurrentgemma-2b", ("camformer", "dense"), RG_TRAIN_B, RG_TRAIN_S, 3,
     3e-4),
    ("rwkv6-3b", ("dense",), 4, 512, 3, 3e-4),
    ("granite-moe-3b-a800m", ("dense",), TRAIN_B, TRAIN_S, 3, 3e-4))
FAMILY_RESUME_STEPS = 2
FULL_TRAIN_SHAPE = "train_4k"


def family_train_launches(cfg, steps):
    """{kernels row: kernel-4 launches} of ``steps`` train steps of
    ``cfg``: one an attention layer in the forward pass and one in its
    recompute, on camformer with ``use_kernel``; none otherwise."""
    if not cfg.use_kernel:
        return {}
    if cfg.family == "audio":
        return {row: 2 * n * steps for row, n in (
            (WHISPER_ENC_TRAIN_ROW, cfg.enc_layers),
            (WHISPER_DEC_TRAIN_ROW, cfg.n_layers),
            (WHISPER_X_TRAIN_ROW, cfg.n_layers))}
    return {RG_TRAIN_ROW: 2 * (cfg.n_layers // 3) * steps}  # 1 in 3 layers


def family_train(arch, backend, b, s, steps, peak_lr):
    """``arch`` at full width and depth trained through ``Trainer`` at b x
    s tokens for ``steps`` steps to ``peak_lr``, as ``python -m
    repro_torch.launch.train --arch <arch>`` drives it (``train_run``;
    its last step profiled, left out of the median): every step's metrics
    finite (the last loss below the first on whisper), the exact kernel-4
    launches of ``family_train_launches``, no plain version on the card,
    the peak allocated memory below the card's total (printed beside the
    state's 16 B a parameter), and what stays allocated after ``del``
    under 0.25 GB; on MoE the aux loss positive and the drop share
    printed.  whisper on camformer checkpoints its last step (under
    ``build/``, removed after) and a second Trainer resumes it.  Returns
    the runs' launches by kernels row."""
    import shutil

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import count_params
    from repro_torch.train.checkpoint import latest_step

    cfg = get_config(arch, attn_backend=backend,
                     use_kernel=backend == "camformer")
    shape, full = train_shape(b, s), SHAPES[FULL_TRAIN_SHAPE]
    resume = cfg.family == "audio" and cfg.use_kernel
    ckpt = ROOT / "build" / "train_families" / f"{arch}-{backend}"
    shutil.rmtree(ckpt, ignore_errors=True)
    total = torch.cuda.mem_get_info()[1]
    live_at_entry = torch.cuda.memory_allocated()
    want = family_train_launches(cfg, steps)
    runs = []
    try:
        run = train_run(cfg, shape, ckpt_dir=ckpt, total_steps=steps,
                        ckpt_every=steps if resume else 10**9, profile=True,
                        peak_lr=peak_lr)
        log_, metrics = run["trainer"].metrics_log, run["metrics"]
        losses = [r["loss"] for r in log_]
        assert [r["step"] for r in log_] == list(range(1, steps + 1)), log_
        assert all(math.isfinite(v) for r in metrics for v in r.values()), \
            metrics
        if cfg.family == "audio":
            assert losses[-1] < losses[0], losses
        got = {k: v for k, v in run["launches"].items() if v}
        assert got == want, (arch, backend, got, want)
        assert run["peak_gb"] * 1e9 < total, (arch, run["peak_gb"], total)
        runs.append(want)
        n = count_params(run["state"]["params"])
        step_s = median_step_s(log_)
        layers = (dict(encoder=cfg.enc_layers, decoder=cfg.n_layers)
                  if cfg.family == "audio" else cfg.n_layers)
        line = dict(
            layers=layers, params=n, batch=b, seq=s, steps=steps,
            peak_lr=peak_lr,
            reduced=dict(shape=FULL_TRAIN_SHAPE,
                         global_batch=[full["global_batch"], b],
                         seq_len=[full["seq_len"], s]),
            wall_s=run["wall_s"], median_step_s=step_s,
            tokens_per_s=b * s / step_s, peak_mem_gb=run["peak_gb"],
            state_gb_at_16_bytes=16 * n / 1e9, mem_total_gb=total / 1e9,
            losses=losses, grad_norm=[r["grad_norm"] for r in log_],
            lr_last=log_[-1]["lr"], kernel4_launches=want)
        if cfg.family == "moe":
            aux = [r["moe_aux_loss"] for r in metrics]
            assert all(a > 0 for a in aux), aux
            line.update(moe_aux_loss=aux,
                        moe_drop_frac=[r["moe_drop_frac"] for r in metrics])
        prof = run["profile"]
        del run
        if resume:
            assert latest_step(str(ckpt)) == steps
            torch.cuda.empty_cache()
            more = steps + FAMILY_RESUME_STEPS
            run = train_run(cfg, shape, ckpt_dir=ckpt, total_steps=more,
                            ckpt_every=steps, peak_lr=peak_lr)
            trainer = run["trainer"]
            assert trainer.events[0] == (
                steps, "resume", f"restored step_{steps}"), trainer.events
            assert [r["step"] for r in trainer.metrics_log] == list(
                range(steps + 1, more + 1)), trainer.metrics_log
            assert all(math.isfinite(r["loss"]) for r in trainer.metrics_log)
            want2 = family_train_launches(cfg, FAMILY_RESUME_STEPS)
            got = {k: v for k, v in run["launches"].items() if v}
            assert got == want2, (arch, "resume", got, want2)
            runs.append(want2)
            line["resume"] = dict(
                event=list(trainer.events[0]), wall_s=run["wall_s"],
                losses=[r["loss"] for r in trainer.metrics_log])
            del run, trainer
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    left = torch.cuda.memory_allocated() - live_at_entry
    line["left_after_del_gb"] = left / 1e9
    assert left < 0.25e9, (arch, backend, "state not freed by del", left)
    torch.cuda.empty_cache()
    label = f"{arch} {backend}{' use_kernel' if cfg.use_kernel else ''}"
    log(f"train {label} bf16 full width and depth: {json.dumps(line)}")
    log(f"profile train {label} (one step): {json.dumps(prof)}")
    return runs


def family_train_phase():
    """Phase 17: ``FAMILY_TRAIN``'s runs one at a time, each freed before
    the next.  What earlier phases left to the cycle collector is
    collected first (and printed).  Returns the runs' launches."""
    t0 = time.perf_counter()
    live = torch.cuda.memory_allocated()
    gc.collect()
    log(f"phase 17 entry: {live / 1e9:.6g} GB live, "
        f"{(live - torch.cuda.memory_allocated()) / 1e9:.6g} GB of it freed "
        f"by gc.collect()")
    runs = []
    for arch, backends, b, s, steps, peak_lr in FAMILY_TRAIN:
        for backend in backends:
            runs += family_train(arch, backend, b, s, steps, peak_lr)
            log(f"phase 17 elapsed {time.perf_counter() - t0:.1f}s: "
                f"{arch}/{backend}")
    return runs


# ---------------------------------------------------------------------------
# phase 18: the long-context shapes at full length on mistral-nemo-12b


def long_requests(vocab):
    """Phase 18 (a)'s 2 seeded 32,704-token prompts of 64 new tokens."""
    from repro_torch.serving import Request, SamplingParams

    rng = np.random.default_rng(SEED + 18)
    return [Request(prompt=[int(t) for t in rng.integers(0, vocab,
                                                         LONG_PROMPT)],
                    sampling=SamplingParams(max_new=LONG_NEW), rid=i)
            for i in range(LONG_SLOTS)]


@contextlib.contextmanager
def stage1_recorded():
    """Record the stage-1 candidates of every call in the block: the
    kernel wrappers' (``kernels/ops.py``) and the plain routes'
    (``core/topk.stage1_topk``).  Yields ``take()``, which returns the
    calls since the last ``take`` as (values, int32 indices), each
    (matrices, rows, candidates) with the calls' rows concatenated in
    call order (layer by layer), and forgets them."""
    import repro_torch.core.topk as topk
    from repro_torch.kernels import ops as kops

    calls, saved = [], []
    for mod, name in ((kops, "bacam_paged_scores_topk"),
                      (kops, "bacam_attention_scores_topk_packed"),
                      (topk, "stage1_topk")):
        fn = getattr(mod, name)

        def recorded(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            calls.append(out)
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, recorded)

    def take():
        first = calls[0][0]  # (B, H_kv, R, N) or (B * H_kv, R, N)
        m = first.shape[0] * (first.shape[1] if first.dim() == 4 else 1)
        n = first.shape[-1]
        out = (torch.cat([v.reshape(m, -1, n) for v, _ in calls], 1),
               torch.cat([i.reshape(m, -1, n).to(torch.int32)
                          for _, i in calls], 1))
        calls.clear()
        return out

    try:
        yield take
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def fill_long(caches, gen):
    """Seeded contents, in place, of camformer's pools or caches: random
    packed-key words, N(0, 1) values at bf16, and each kv head's
    ``k_scale`` the mean |x| of a 4,096-sample N(0, 1) draw (about
    0.8)."""
    for cache in caches:
        for name, t in cache.items():
            if name == "k_scale":
                t.copy_(torch.randn((*t.shape, 4096), generator=gen,
                                    device="cuda").abs().mean(-1))
            elif t.dtype == torch.int32:
                t.copy_(long_words(gen, *t.shape))
            else:
                t.normal_(generator=gen)


def long_routes(cfg, step_of, routes, caches, row):
    """``LONG_STEPS`` greedy decode steps of one slot from
    ``LONG_FILLED`` through each of ``routes`` ((label, config, kernel
    launched)) in turn, each from the same state (``k_scale`` restored;
    the positions the steps write are written before they are read):
    ``step_of(config)(tokens, pos, kv_len)`` returns the logits.  The
    first route's stage-1 candidates, logits and greedy tokens are the
    others': candidates identical at every step and layer, tokens
    identical, logits within 1e-5 of max |logits|.  The kernel route
    launches kernel ``row`` once a layer a step and nothing else, and no
    plain version on the card; the others launch nothing.  Returns
    ({route: numbers}, {row: launches})."""
    n = cfg.n_layers
    k_scale = [c["k_scale"].clone() for c in caches]
    tok0 = int(np.random.default_rng(SEED + 18).integers(cfg.vocab))
    first, out, kernel_launches = None, {}, {}
    for label, run_cfg, kernel in routes:
        for c, ks in zip(caches, k_scale):
            c["k_scale"] = ks.clone()
        step = step_of(run_cfg)
        tok = torch.tensor([tok0], dtype=torch.int32, device="cuda")
        toks, logits, ms, cands = [], [], [], []
        reset_launches()
        with stage1_recorded() as take, plain_calls_on_card() as plain, \
                torch.no_grad():
            for t in range(LONG_STEPS):
                pos = torch.tensor([LONG_FILLED + t], dtype=torch.int32,
                                   device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg = step(tok, pos, pos + 1)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                toks.append(int(tok))
                logits.append(lg)
                tok = lg.argmax(-1).to(torch.int32)
                vals, idx = take()
                if first is None:
                    if t == 0:  # each layer's step-1 candidates
                        by_layer = vals.reshape(LONG_HKV, n, -1)
                        stats = dict(
                            distinct_scores_by_layer=[
                                int(by_layer[:, i].unique().numel())
                                for i in range(n)],
                            tied_pair_share_by_layer=[
                                round(float((by_layer[:, i, 0::2]
                                             == by_layer[:, i, 1::2])
                                            .float().mean()), 4)
                                for i in range(n)])
                    cands.append((vals.cpu(), idx.cpu()))
                    continue
                want_v, want_i = (x.cuda() for x in first["cands"][t])
                assert torch.equal(vals, want_v), (label, t, "values")
                assert torch.equal(idx, want_i), (label, t, "indices")
                del want_v, want_i
        launches = read_launches()
        if kernel:
            assert launches[row] == n * LONG_STEPS, (label, launches)
            assert plain == {}, (label, plain)
        assert sum(launches.values()) == (n * LONG_STEPS if kernel else 0), (
            label, launches)
        numbers = dict(step_ms=ms, median_step_ms=statistics.median(ms),
                       tokens_per_s=1e3 / statistics.median(ms),
                       tokens=toks, launches={k: v for k, v in
                                              launches.items() if v},
                       plain_calls_on_card=plain)
        if first is None:
            numbers.update(stats)
            first = dict(cands=cands, logits=logits, toks=toks)
        else:
            top = max(float(x.abs().max()) for x in first["logits"])
            err = max(float((a - b).abs().max())
                      for a, b in zip(logits, first["logits"]))
            assert toks == first["toks"], (label, toks, first["toks"])
            assert err <= 1e-5 * top, (label, err, top)
            numbers.update(max_abs_logit_diff=err, max_abs_logit=top,
                           candidates_identical=True, tokens_identical=True)
        out[label] = numbers
        if kernel:
            kernel_launches = {LONG_ROWS[row]: launches[row]}
    return out, kernel_launches


def long_paged_leg(params):
    """Phase 18 (b): long_500k on the paged pools: camformer's
    ``md.page_specs`` with 8,192 live pages and the trash page, filled
    from the seed (``fill_long``), one slot whose page table is a seeded
    permutation of the pool's pages, decoded 8 steps from position
    524,280 through ``lm_decode_paged`` on ``paged_impl="fused"``
    (kernel 1 over 8,192 pages a layer) and on ``"gather"``."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model_def, init_pools

    cfg = get_config(LONG_ARCH).replace(attn_backend="camformer")
    md = get_model_def(cfg)
    total = torch.cuda.mem_get_info()[1]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n_live = LONG_KEYS // LONG_PAGE
    pools = init_pools(md.page_specs(cfg, 1 + n_live, LONG_PAGE, 1), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 180)
    fill_long(pools, gen)
    table = (torch.randperm(n_live, generator=gen, device="cuda") + 1).to(
        torch.int32)[None]
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0

    def step_of(run_cfg):
        return lambda tok, pos, kv_len: md.decode_paged(
            params, tok, pos, kv_len, pools, table, run_cfg)[0]

    routes, launches = long_routes(
        cfg, step_of, [("fused", cfg.replace(paged_impl="fused"), True),
                       ("gather", cfg.replace(paged_impl="gather"), False)],
        pools, "bacam_paged_topk_stage1")
    line = dict(pool_gb=tensor_bytes(pools) / 1e9, fill_s=fill_s,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                mem_total_gb=total / 1e9, **routes)
    assert line["peak_mem_gb"] * 1e9 < total, line
    log(f"phase 18 (b) long_500k paged {LONG_ARCH}/camformer, 1 slot x "
        f"{LONG_KEYS} positions ({n_live} pages of {LONG_PAGE}), bf16: "
        f"{json.dumps(line)}")
    del pools, table
    torch.cuda.empty_cache()
    return launches


def long_contiguous_leg(params):
    """Phase 18 (c): long_500k on the contiguous path, the dry run's cell:
    camformer's ``md.cache_specs`` at one row of 524,288 positions,
    filled from the seed, decoded 8 steps from position 524,280 through
    ``launch/steps.make_serve_step`` with ``use_kernel`` (kernel 3 over
    the 8 kv heads' matrices of G = 4 rows a layer) and without; the
    caches are written in place."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import get_model_def, init_pools

    cfg = get_config(LONG_ARCH).replace(attn_backend="camformer")
    md = get_model_def(cfg)
    total = torch.cuda.mem_get_info()[1]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    caches = init_pools(md.cache_specs(cfg, 1, LONG_KEYS), "cuda")
    fill_long(caches, torch.Generator(device="cuda").manual_seed(SEED + 181))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    held = [c["v"] for c in caches]

    def step_of(run_cfg):
        serve = make_serve_step(md, run_cfg)

        def step(tok, pos, kv_len):
            logits, out = serve(params, tok, pos, kv_len, caches)
            assert all(c["v"] is h for c, h in zip(out, held)), \
                "the cache was copied"
            return logits
        return step

    routes, launches = long_routes(
        cfg, step_of, [("kernel", cfg.replace(use_kernel=True), True),
                       ("plain", cfg.replace(use_kernel=False), False)],
        caches, "bacam_topk_stage1")
    line = dict(cache_gb=tensor_bytes(caches) / 1e9, fill_s=fill_s,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                mem_total_gb=total / 1e9, **routes)
    assert line["peak_mem_gb"] * 1e9 < total, line
    log(f"phase 18 (c) long_500k contiguous {LONG_ARCH}/camformer, 1 x "
        f"{LONG_KEYS} positions, bf16: {json.dumps(line)}")
    del caches, held
    torch.cuda.empty_cache()
    return launches


def long_context_phase():
    """Phase 18: mistral-nemo-12b at full width and depth, its bf16
    weights drawn once (by leg (a)'s engine) for three legs, each leg's
    cache freed before the next: (a) prefill_32k / decode_32k on dense,
    the engine ``python -m repro_torch.launch.serve --arch
    mistral-nemo-12b --backend dense --max-batch 2 --max-len 32768
    --prefill-chunk 4096`` builds, serving 2 prompts of 32,704 tokens
    (8 chunks of 4,096 a prefill tick) to 64 new tokens with
    ``serve_run``'s checks; (b) ``long_paged_leg``; (c)
    ``long_contiguous_leg``.  Returns the legs' launches, in the rows of
    ``LONG_ROWS``."""
    t0 = time.perf_counter()
    live = torch.cuda.memory_allocated()
    gc.collect()
    log(f"phase 18 entry: {live / 1e9:.6g} GB live, "
        f"{(live - torch.cuda.memory_allocated()) / 1e9:.6g} GB of it freed "
        f"by gc.collect()")
    keep = {}
    _, launches, result, _ = serve_run(
        "dense", arch=LONG_ARCH, profile=False, requests=long_requests,
        chunks=LONG_LEN // LONG_CHUNK, keep=keep,
        flags=["--max-batch", str(LONG_SLOTS), "--max-len", str(LONG_LEN),
               "--prefill-chunk", str(LONG_CHUNK)])
    log(f"phase 18 (a) prefill_32k + decode_32k {LONG_ARCH}/dense, "
        f"{LONG_SLOTS} x {LONG_PROMPT}-token prompts in chunks of "
        f"{LONG_CHUNK}, {LONG_NEW} new tokens: " + json.dumps({
            k: result[k] for k in (
                "ttft_p50_s", "ttft_max_s", "decode_tokens_per_s", "pool_gb",
                "peak_mem_gb", "build_peak_mem_gb", "build_s", "wall_s",
                "ticks", "prefill_ticks", "readbacks", "launches")}))
    runs = [{LONG_ROWS.get(k, k): v for k, v in launches.items()}]
    log(f"phase 18 elapsed {time.perf_counter() - t0:.1f}s: (a)")
    params = keep.pop("params")
    runs.append(long_paged_leg(params))
    log(f"phase 18 elapsed {time.perf_counter() - t0:.1f}s: (b)")
    runs.append(long_contiguous_leg(params))
    del params
    torch.cuda.empty_cache()
    log(f"phase 18: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.6g} GB still allocated")
    return runs


def kernel_instance(mangled):
    """``name<N, ...>`` of a mangled ``..._kernel<N, ...>`` (Itanium: a name
    is its length, then its characters; int and bool template arguments
    ``Li<N>E``, ``Lb<0|1>E``)."""
    for run in re.finditer(r"\d+", mangled):
        for i in range(run.start(), run.end()):
            n = int(mangled[i:run.end()])
            name = mangled[run.end():run.end() + n]
            if name.endswith("_kernel"):
                inst = re.match(r"I((?:L[ib]\d+E)+)E", mangled[run.end() + n:])
                args = re.findall(r"\d+", inst.group(1)) if inst else []
                return name + (f"<{', '.join(args)}>" if args else "")
    return mangled


STAGE1_TESTS = "bacam_kernel or topk_kernel or stage1 or contiguous_path"


def stage1_bounds_check(n_orders=3):
    """The stage-1 fault check (``--stage1-bounds``): the two BA-CAM
    stage-1 sources built with their bounds check (``kernels/build.py``:
    every global access trapped outside its tensor, a synchronize after
    every launch), then the ``gpu``-marked stage-1 tests of
    ``tests/test_torch_cuda.py`` in ``n_orders`` shuffled orders (one
    pytest process each), then the kernel phases in this process.  Raises
    on the first failure."""
    import os

    from repro_torch.kernels import build

    os.environ[build.BOUNDS_ENV] = "1"  # this process and the pytest ones
    took = build.build(build.STAGE1_SOURCES)
    log(f"stage-1 bounds build: {took} (flags "
        f"{build.flags(build.STAGE1_SOURCES[0])})")
    test_file = str(ROOT / "tests" / "test_torch_cuda.py")
    pytest = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
              "-m", "gpu"]
    ids = subprocess.run(
        pytest + ["--collect-only", "-k", STAGE1_TESTS, test_file],
        capture_output=True, text=True, check=True, cwd=ROOT).stdout
    ids = [line for line in ids.splitlines() if "::" in line]
    assert ids, "no stage-1 tests collected"
    for seed in range(n_orders):
        order = [ids[i] for i in np.random.default_rng(seed).permutation(
            len(ids))]
        proc = subprocess.run(pytest + order, capture_output=True, text=True,
                              cwd=ROOT)
        tail = proc.stdout.strip().splitlines()[-1:]
        log(f"stage-1 bounds, order {seed} ({len(order)} tests, first "
            f"{order[0].split('::')[1]}): exit {proc.returncode} {tail}")
        assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    n_rows = len(kernel_phase(flush) + contiguous_kernel_phase(flush))
    torch.cuda.synchronize()
    log(f"stage-1 bounds, kernel phases ({n_rows} timed rows, every launch "
        f"synchronized): no trap")
    return dict(orders=n_orders, tests=len(ids), trapped=False)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    log(smi_line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    if sys.argv[1:] == ["--stage1-bounds"]:
        print(json.dumps({"stage1_bounds": stage1_bounds_check()}))
        return 0

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    took = build.build(build.SOURCES)
    log(f"build: {time.perf_counter() - t0:.1f}s wall "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in took.items())}) "
        f"into {build.BUILD_DIR}")
    for name in build.SOURCES:  # registers, spills and shared memory
        kernel = ""
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_instance(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {kernel}: {line.strip()}")

    # 256 MiB, five times the L2, overwritten before each timed launch
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    log(f"launch floor: {launch_floor(flush):.6g} ms (a one-element zero_()"
        f" under the kernels' timing: L2 flushed, CUDA events)")
    rows = (kernel_phase(flush) + assigned_kernel_phase(flush)
            + contiguous_kernel_phase(flush) + train_kernel_phase(flush)
            + families_kernel_phase(flush) + long_kernel_phase(flush))
    del flush
    log(f"gqa3 parity: {json.dumps(gqa3_kernel_phase())}")
    parity_phase()
    log(f"moe parity: {json.dumps(moe_parity_phase())}")
    contiguous_parity_phase()
    spec_exactness_phase()
    draw_dtype_check()
    log(f"elapsed {time.perf_counter() - t0:.1f}s: kernels and parity")
    runs = list(slice_phase().values()) + list(spec_phase().values())
    log(f"elapsed {time.perf_counter() - t0:.1f}s: paged slice")
    runs += list(contiguous_slice_phase().values())
    log(f"elapsed {time.perf_counter() - t0:.1f}s: contiguous slice")
    moe_runs = moe_slice_phase()
    log(f"elapsed {time.perf_counter() - t0:.1f}s: MoE slice")
    vlm = vlm_contiguous_phase()
    log(f"elapsed {time.perf_counter() - t0:.1f}s: VLM leg")
    log(f"launches on the MoE and VLM paths: " + json.dumps(dict(
        {f"granite {k}": {n: c for n, c in v.items() if c}
         for k, v in moe_runs.items()},
        vlm={n: c for n, c in vlm.items() if c})))
    runs += list(moe_runs.values()) + [vlm]
    runs += training_phase()
    log(f"elapsed {time.perf_counter() - t0:.1f}s: training")
    runs += gateway_phase(smi_line)
    log(f"elapsed {time.perf_counter() - t0:.1f}s: gateway")
    runs += families_phase()
    log(f"elapsed {time.perf_counter() - t0:.1f}s: encoder-decoder and "
        f"Griffin families")
    runs += ssm_device_phase()
    log(f"elapsed {time.perf_counter() - t0:.1f}s: ssm family and device "
        f"model")
    runs += distribution_phase(smi_line)
    log(f"elapsed {time.perf_counter() - t0:.1f}s: distribution")
    runs += tp_share_phase(smi_line)
    log(f"elapsed {time.perf_counter() - t0:.1f}s: tp shares")
    runs += share_phase(smi_line)
    log(f"elapsed {time.perf_counter() - t0:.1f}s: model-split shares")
    runs += serve_share_phase(smi_line)
    log(f"elapsed {time.perf_counter() - t0:.1f}s: sharded serving shares")
    runs += assigned_phase()
    log(f"elapsed {time.perf_counter() - t0:.1f}s: assigned LMs")
    runs += family_train_phase()
    log(f"elapsed {time.perf_counter() - t0:.1f}s: families trained")
    runs += long_context_phase()
    log(f"elapsed {time.perf_counter() - t0:.1f}s: long contexts")
    for row in rows:  # launches over every path run
        row["launches"] = sum(run.get(row["name"], 0) for run in runs)
        if row["path"] != "none":
            assert row["launches"] > 0, row
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if row[key] is not None:
                assert math.isfinite(row[key]), row
    keys = ("name", "route", "path", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
