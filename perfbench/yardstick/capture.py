"""The program's own state, taken from the timed path.

CAMformer binarizes q and k and selects keys by integer scores, so the
model is a discontinuous function of its inputs: rounding that flips one
sign near zero changes a selection, and the change grows through the
layers (PERF.md: a 1e-6 change to the embeddings moves the logits by
0.64 after four layers).  A bfloat16 program and a float32 reference
run end to end disagree about as much as a float8 one does, and no limit
on such a comparison could tell them apart.  So the check follows the
program step by step from its own state.  For the requests the clients
mark at submission (``watch``: those of a few clients drawn from the
seed, up to the mix's ``check_positions`` positions in all, so that the
buffers stay bounded whatever the throughput), this records, as the
engine computes them in prefill and decode ticks alike:

* ``x``: the rows entering every decoder layer and leaving the last one;
* ``o``: every layer's attention output before its output projection
  (the CAM backend's ``paged_decode`` result, heads side by side);
* ``logits``: the vocabulary logits of every row the engine samples.

Wrappers, installed for the run and removed by ``close``: the engine's
``_dispatch_step`` / ``_prefill_step`` / ``_decode_step`` (which rows
of the tick belong to a recorded request, from the tick's host plan and
``sched.active``), ``repro_torch.models.transformer._apply_block`` and
``_head_logits``, and the ``paged_decode`` of the layers' backends: an
``index_select`` of the recorded rows each, on the device, in the ticks
that hold such rows.  These program seams are what the check depends on
(PERF.md names them).
"""

from __future__ import annotations

import numpy as np
import torch


class Capture:
    def __init__(self, eng):
        from repro_torch.core.backend import backends_for
        from repro_torch.models import transformer as T

        self.T, self.eng = T, eng
        self.orig = {"_apply_block": T._apply_block,
                     "_head_logits": T._head_logits}
        self.n_layers = len(eng.params["blocks"])
        self.layer_of = {id(b): i for i, b in enumerate(eng.params["blocks"])}
        self.watch = set()  # rids recorded
        self.held = 0  # positions the watched requests can reach
        self.on = False
        self.ticks = []  # (x/o rows [(rid, pos)], logit rows, store)
        self._ctx = self._plan = None
        self._layer = None
        orig_dispatch = eng._dispatch_step
        orig_prefill, orig_decode = eng._prefill_step, eng._decode_step
        flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731

        def dispatch(plan):
            self._plan = plan
            try:
                return orig_dispatch(plan)
            finally:
                self._plan = self._ctx = None

        def stepper(kind, orig):
            def step(*a, **kw):
                self._ctx = self._rows(kind)
                try:
                    return orig(*a, **kw)
                finally:
                    self._ctx = None
            return step

        def block(p, x, cfg, **kw):
            ctx, li = self._ctx, self.layer_of.get(id(p))
            if ctx is None or li is None:
                return self.orig["_apply_block"](p, x, cfg, **kw)
            store = ctx["store"]
            store["x"][li] = flat(x).index_select(0, ctx["idx"])
            self._layer = li
            try:
                out = self.orig["_apply_block"](p, x, cfg, **kw)
            finally:
                self._layer = None
            if li == self.n_layers - 1:
                store["x"][li + 1] = flat(out[0]).index_select(0, ctx["idx"])
            return out

        def head(params, last, cfg):
            logits = self.orig["_head_logits"](params, last, cfg)
            ctx = self._ctx
            if ctx is not None and ctx["lidx"] is not None:
                ctx["store"]["logits"] = flat(logits).index_select(
                    0, ctx["lidx"])
            return logits

        self.backends = []
        for bk in {id(b): b for b in backends_for(eng.cfg)}.values():
            orig_pd = bk.paged_decode

            def paged_decode(*a, _orig=orig_pd, **kw):
                out, cache = _orig(*a, **kw)
                ctx, li = self._ctx, self._layer
                if ctx is not None and li is not None:
                    o = out.transpose(1, 2)  # (B, S, H, D)
                    ctx["store"]["o"][li] = o.reshape(
                        -1, o.shape[2] * o.shape[3]).index_select(
                            0, ctx["idx"])
                return out, cache

            bk.paged_decode = paged_decode
            self.backends.append(bk)
        eng._dispatch_step = dispatch
        eng._prefill_step = stepper("prefill", orig_prefill)
        eng._decode_step = stepper("decode", orig_decode)
        T._apply_block, T._head_logits = block, head

    def close(self):
        for name, fn in self.orig.items():
            setattr(self.T, name, fn)
        for bk in self.backends:
            bk.__dict__.pop("paged_decode", None)
        for name in ("_dispatch_step", "_prefill_step", "_decode_step"):
            self.eng.__dict__.pop(name, None)
        self.eng = None

    def _rows(self, kind):
        """The tick's context: device indices of the rows of recorded
        requests (``idx`` into the (B * S) rows of the layers, ``lidx``
        into the (B) rows of the logits), and the store their rows go
        to; None when the tick holds none."""
        plan = self._plan
        if not self.on or plan is None:
            return None
        active = self.eng.sched.active
        flat, rows, lflat, lrows = [], [], [], []
        if kind == "prefill":
            pf = plan.prefill
            s = pf.tokens.shape[1]
            for i in np.nonzero(pf.lens > 0)[0]:
                r = active[i]
                if r is None or r.rid not in self.watch:
                    continue
                n = int(pf.lens[i] - pf.offsets[i])
                flat.extend(int(i) * s + j for j in range(n))
                rows.extend((r.rid, int(pf.offsets[i]) + j) for j in range(n))
            for e in pf.emit:
                r = active[e.slot]
                if r is not None and r.rid in self.watch:
                    lflat.append(int(e.slot))
                    lrows.append((r.rid, int(pf.lens[e.slot]) - 1))
        else:
            dc = plan.decode
            for i in np.nonzero(dc.live)[0]:
                r = active[i]
                if r is None or r.rid not in self.watch:
                    continue
                flat.append(int(i))
                rows.append((r.rid, int(dc.pos[i])))
            lflat, lrows = list(flat), list(rows)
        if not rows:
            return None
        store = {"x": [None] * (self.n_layers + 1),
                 "o": [None] * self.n_layers, "logits": None}
        self.ticks.append((rows, lrows, store))
        h2d = lambda a: self.eng._h2d(np.asarray(a, dtype=np.int64))  # noqa
        return {"idx": h2d(flat), "lidx": h2d(lflat) if lflat else None,
                "store": store}

    def states(self, wanted) -> list:
        """For each (rid, length, served) of ``wanted``: {"x": (n_layers +
        1, length, d), "o": (n_layers, length, H * D), "logits": (served,
        V)}, the rows of that request at positions 0..length-1 (logits at
        length - served .. length - 1).  Raises if a position was not
        recorded exactly once."""
        index, lindex = {}, {}
        for rows, lrows, _ in self.ticks:
            for table, keys in ((index, rows), (lindex, lrows)):
                for key in keys:
                    if key in table:
                        raise RuntimeError(f"request {key[0]} position "
                                           f"{key[1]} recorded twice")
                    table[key] = len(table)
        if not wanted:
            return []
        stores = [st for _, _, st in self.ticks]
        xs = [torch.cat([st["x"][li] for st in stores])
              for li in range(self.n_layers + 1)]
        os_ = [torch.cat([st["o"][li] for st in stores])
               for li in range(self.n_layers)]
        lg = torch.cat([st["logits"] for st in stores
                        if st["logits"] is not None])
        out = []
        for rid, length, served in wanted:
            pos = range(length)
            lpos = range(length - served, length)
            missing = [p for p in pos if (rid, p) not in index] + \
                [p for p in lpos if (rid, p) not in lindex]
            if missing:
                raise RuntimeError(f"request {rid}: positions {missing[:4]}"
                                   f" ({len(missing)}) not recorded")
            dev = xs[0].device
            idx = torch.tensor([index[(rid, p)] for p in pos], device=dev)
            lidx = torch.tensor([lindex[(rid, p)] for p in lpos], device=dev)
            out.append({"x": torch.stack([t.index_select(0, idx)
                                          for t in xs]),
                        "o": torch.stack([t.index_select(0, idx)
                                          for t in os_]),
                        "logits": lg.index_select(0, lidx)})
        return out
