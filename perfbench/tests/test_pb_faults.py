"""Each fault a serving cell can have, planted in the timed path
underneath a CPU run of the harness, makes ``correct`` come out false:
a step that leaves its state unchanged, half of the batch left out of a
decode tick, a token altered where it is produced; and, since the
compared numbers are taken a layer at a time and for prefill and decode
rows apart, a fault in one layer alone and a fault in decode ticks
alone.  (One card: no exchange between chips to leave out.)  The runs
record the requests the rag mix's own ``check_clients`` and
``check_positions`` pick, of 8 clients."""

import json

import numpy as np
import pytest
import torch

import run


def _correct(root, capsys, cell="nemo12b-cam.rag"):
    """``correct`` and the checks of a 4 s run of 8 clients."""
    mix = root / "perfbench" / "traffic" / f"{cell.split('.')[1]}.json"
    t = json.loads(mix.read_text())
    t.update(clients=8)
    mix.write_text(json.dumps(t))
    rc = run.main(["--workload", cell, "--seed", "5", "--seconds", "4",
                   "--trace", "0"], device="cpu", root=root)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return res["correct"], res["check"]


def _over(checks, name) -> bool:
    c = checks[name]
    return c["value"] is not None and c["value"] > c["limit"]


def test_sound_run_is_correct(smoke_root, capsys):
    ok, checks = _correct(smoke_root, capsys)
    assert ok, checks


def test_state_left_unchanged(smoke_root, capsys, monkeypatch):
    from repro_torch.core.backend import CamformerBackend

    monkeypatch.setattr(CamformerBackend, "_paged_write",
                        lambda self, cache, *a, **kw: cache)
    ok, checks = _correct(smoke_root, capsys)
    assert not ok
    assert _over(checks, "attn_err_prefill"), checks


def test_half_the_batch_left_out(smoke_root, capsys, monkeypatch):
    """Decode ticks run the first half of the slots; the rest keep the
    rows of the first half (their mean taken over the others)."""
    from repro_torch.serving import engine as E

    orig = E.ServeEngine._decode_step

    def half(self, tok_prev, fresh, fresh_mask, live_mask, pos, kv_len, pt,
             base, hot, samp):
        b = live_mask.shape[0]
        keep = np.arange(b) < (b + 1) // 2
        keep_t = self._h2d(keep)
        src = self._h2d(np.arange(b) % ((b + 1) // 2))
        out = orig(self, tok_prev, fresh, fresh_mask, live_mask & keep_t,
                   pos, kv_len, pt, base, hot, samp)
        return out[src.long()]

    monkeypatch.setattr(E.ServeEngine, "_decode_step", half)
    ok, checks = _correct(smoke_root, capsys)
    assert not ok, checks


@pytest.mark.parametrize("cell", ("nemo12b-cam.rag", "bertl-cam.rag"))
def test_token_altered(smoke_root, capsys, monkeypatch, cell):
    from repro_torch.serving import sampler

    orig = sampler.greedy
    monkeypatch.setattr(sampler, "greedy",
                        lambda logits: (orig(logits) + 1) % 200)
    ok, checks = _correct(smoke_root, capsys, cell)
    assert not ok
    assert checks["argmax_miss"]["value"] > 0


def test_one_layer_off(smoke_root, capsys, monkeypatch):
    """The last layer's update is 1% too large, in every tick; the other
    layers are sound."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E

    orig, init = T._apply_block, E.ServeEngine.__init__
    last = []

    def init_last(self, cfg, params, **kw):
        init(self, cfg, params, **kw)
        last[:] = [self.params["blocks"][-1]]

    def block(p, x, cfg, **kw):
        out = orig(p, x, cfg, **kw)
        if not last or p is not last[0]:
            return out
        return (x + (out[0] - x) * 1.01,) + tuple(out[1:])

    monkeypatch.setattr(E.ServeEngine, "__init__", init_last)
    monkeypatch.setattr(T, "_apply_block", block)
    ok, checks = _correct(smoke_root, capsys)
    assert not ok
    assert _over(checks, "rest_err_prefill") and \
        _over(checks, "rest_err_decode"), checks


def test_decode_ticks_off(smoke_root, capsys, monkeypatch):
    """CAMformer's attention output is 2% too large in decode ticks
    (one query row a slot) and sound in prefill ticks."""
    from repro_torch.core.backend import CamformerBackend

    orig = CamformerBackend.paged_decode

    def paged_decode(self, q, *a, **kw):
        out, cache = orig(self, q, *a, **kw)
        if q.shape[2] == 1:
            out = out * torch.tensor(1.02, dtype=out.dtype)
        return out, cache

    monkeypatch.setattr(CamformerBackend, "paged_decode", paged_decode)
    ok, checks = _correct(smoke_root, capsys)
    assert not ok
    assert _over(checks, "attn_err_decode"), checks
    assert not _over(checks, "attn_err_prefill"), checks
