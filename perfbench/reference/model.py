"""Plain PyTorch reference of the served decoder LM with CAMformer
attention, in float32 (TF32 off).

It imports nothing of the program.  It is given the configuration's
numbers, the weights the benchmark drew (a tree of tensors:
``embed.tok`` (V_pad, d), ``embed.head`` (d, V_pad), ``blocks[i]`` with
``ln1.scale``, ``attn.{wq, wk, wv, wo}``, ``ln2.scale``,
``ffn.{w_gate, w_up, w_down}``, and ``ln_f.scale``; matrices applied as
``x @ W``) and each request's prompt and served tokens, laid out one
sequence after another (``spans_of``).  ``hidden_states`` runs the whole
model over them; ``attention``, ``after_attention`` and ``head_logits``
run one stage on rows given to them (the benchmark's check hands them
the program's own rows, stage by stage), rebuilding every key and value
from those rows.

The model, as the configuration states it:

* token embedding; per layer x += attn(rms(x)); x += ffn(rms(x)); a
  final RMSNorm (eps 1e-6, then the scale) and the vocabulary head, the
  pad columns beyond ``vocab`` left out;
* attention: q/k/v projections, half-split RoPE (frequencies
  theta ** (-i / (D/2)) rounded from float64), then CAMformer (the
  paper's Eq. 1): sign-binarized q and k (``x > 0`` is +1, else -1),
  the integer score q_b . k_b of every causal key, stage 1 the top
  ``stage1_k`` of each group of ``group_size`` keys (groups by absolute
  key index), stage 2 the top ``k_top`` of those candidates, both
  stable (ties to the lowest index); softmax over the survivors of
  score x mean|q| x k_scale / sqrt(D), and the weighted sum of their
  value rows; G = n_heads / n_kv_heads query heads share a kv head;
* ``k_scale``, the key scale of a query's kv head, is the mean over
  keys of mean|k|: over the whole prompt for the prompt's positions
  (they are written together, in one prefill), over the keys up to and
  including its own position for every later (decoded) position;
* FFN: (silu(x W_gate) * x W_up) W_down.

``precision="fp8"`` is the control: every matrix product's operands are
rounded to float8 e4m3 first (activations a scale a row, weights a scale
an output column), the rest as above.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1.0e9
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    w = w.to(torch.float32)
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms(x, scale, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.to(torch.float32)


def _rope(x, theta: float):
    """x: (H, T, D) at positions 0..T-1."""
    _, t, d = x.shape
    half = d // 2
    ex = -torch.arange(half, dtype=torch.float64, device=x.device) / half
    freqs = (float(theta) ** ex).to(torch.float32)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _stable_top(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def camformer_attention(q, k, v, prompt_len: int, m: dict):
    """q: (H, T, D), k/v: (H_kv, T, D) float32 after RoPE; the first
    ``prompt_len`` positions are the prompt.  Returns (H, T, D)."""
    h, t, d = q.shape
    hkv = k.shape[0]
    g = h // hkv
    grp, s1, ktop = m["group_size"], m["stage1_k"], m["k_top"]
    q_scale = q.abs().mean(-1).reshape(hkv, g, t)
    kmean = k.abs().mean(-1)  # (H_kv, T)
    run = kmean.cumsum(-1) / torch.arange(1, t + 1, device=q.device,
                                          dtype=torch.float32)
    k_scale = run.clone()
    k_scale[:, :prompt_len] = run[:, prompt_len - 1:prompt_len]
    qb = torch.where(q > 0, 1.0, -1.0).reshape(hkv, g, t, d)
    kb = torch.where(k > 0, 1.0, -1.0)
    scores = torch.einsum("hgtd,hsd->hgts", qb, kb)
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal, scores, torch.full_like(scores, NEG_INF))
    pad = (-t) % grp
    if pad:
        scores = F.pad(scores, (0, pad), value=NEG_INF)
    n_grp = scores.shape[-1] // grp
    v1, i1 = _stable_top(scores.reshape(hkv, g, t, n_grp, grp), s1)
    i1 = i1 + (torch.arange(n_grp, device=q.device) * grp)[:, None]
    cand_v = v1.reshape(hkv, g, t, n_grp * s1)
    cand_i = i1.reshape(hkv, g, t, n_grp * s1)
    top_v, sel = _stable_top(cand_v, min(ktop, cand_v.shape[-1]))
    top_i = torch.gather(cand_i, -1, sel).clamp(max=t - 1)
    valid = top_v > NEG_INF / 2
    temp = (q_scale * k_scale[:, None, :] / math.sqrt(d))[..., None]
    logits = torch.where(valid, top_v * temp, torch.full_like(top_v, NEG_INF))
    w = torch.where(valid, torch.softmax(logits, dim=-1),
                    torch.zeros_like(logits))
    heads = torch.arange(hkv, device=q.device)[:, None, None, None]
    v_sel = v[heads, top_i]  # (H_kv, G, T, K, D)
    out = torch.einsum("hgtk,hgtkd->hgtd", w, v_sel)
    return out.reshape(h, t, d)


def _attention(p, x, spans, m, precision):
    """The attention outputs before the output projection, (N, H * D),
    of rows x (N, d): sequence by sequence."""
    hd, h, hkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    a = p["attn"]
    hin = _rms(x, p["ln1"]["scale"])
    q, k, v = (_mm(hin, a[w], precision) for w in ("wq", "wk", "wv"))
    att = []
    for s0, t, plen in spans:
        qi = q[s0:s0 + t].reshape(t, h, hd).transpose(0, 1)
        ki = k[s0:s0 + t].reshape(t, hkv, hd).transpose(0, 1)
        vi = v[s0:s0 + t].reshape(t, hkv, hd).transpose(0, 1)
        qi, ki = _rope(qi, m["rope_theta"]), _rope(ki, m["rope_theta"])
        att.append(camformer_attention(qi, ki, vi, plen, m)
                   .transpose(0, 1).reshape(t, h * hd))
    return torch.cat(att)


def _after_attention(p, x, o, precision):
    """x + o W_o, then the FFN's residual update."""
    x = x + _mm(o, p["attn"]["wo"], precision)
    f = p["ffn"]
    hin = _rms(x, p["ln2"]["scale"])
    gate = F.silu(_mm(hin, f["w_gate"], precision))
    return x + _mm(gate * _mm(hin, f["w_up"], precision), f["w_down"],
                   precision)


class _NoTF32:
    """TF32 off for the matrix products inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def spans_of(requests):
    """(token ids, spans) of prompt + served[:-1] of each request, one
    after another: spans are (start row, length, prompt length)."""
    ids, spans = [], []
    for prompt, served in requests:
        seq = list(prompt) + list(served[:-1])
        spans.append((len(ids), len(seq), len(prompt)))
        ids.extend(seq)
    return ids, spans


def served_rows(spans):
    """Rows whose outputs predict the served tokens: the prompt's last
    position and every later one."""
    return torch.cat([torch.arange(s0 + plen - 1, s0 + t)
                      for s0, t, plen in spans])


def embed(params, ids):
    tok = params["embed"]["tok"]
    return tok[torch.as_tensor(ids, dtype=torch.long,
                               device=tok.device)].to(torch.float32)


@torch.no_grad()
def attention(p, x, spans, m: dict, precision: str = "fp32"):
    """A layer's attention outputs (N, H * D) before W_o, of rows ``x``
    (N, d) float32."""
    with _NoTF32():
        return _attention(p, x, spans, m, precision)


@torch.no_grad()
def after_attention(p, x, o, precision: str = "fp32"):
    """The rest of the layer: rows ``x`` plus o W_o, then the FFN."""
    with _NoTF32():
        return _after_attention(p, x, o, precision)


@torch.no_grad()
def head_logits(params, x, m: dict, precision: str = "fp32"):
    """Final norm and vocabulary head of rows ``x`` (n, d): (n, vocab)."""
    with _NoTF32():
        hf = _rms(x, params["ln_f"]["scale"])
        return _mm(hf, params["embed"]["head"], precision)[:, :m["vocab"]]


@torch.no_grad()
def hidden_states(m: dict, params: dict, requests, precision: str = "fp32"):
    """The residual stream entering every layer and leaving the last,
    (n_layers + 1) tensors (N, d) over the rows of ``spans_of``, and
    every layer's attention output before W_o, n_layers tensors (N, H *
    D)."""
    ids, spans = spans_of(requests)
    xs, os_ = [embed(params, ids)], []
    for p in params["blocks"]:
        os_.append(attention(p, xs[-1], spans, m, precision))
        xs.append(after_attention(p, xs[-1], os_[-1], precision))
    return xs, os_


def served_logits(m: dict, params: dict, requests, precision: str = "fp32"):
    """Logits (n_i, vocab) float32 of each request's served positions:
    row j of a result is the distribution of served token j, read at
    position len(prompt) - 1 + j of prompt + served[:-1]."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"precision {precision!r}")
    _, spans = spans_of(requests)
    xs, _ = hidden_states(m, params, requests, precision)
    rows = served_rows(spans).to(xs[-1].device)
    logits = head_logits(params, xs[-1][rows], m, precision)
    return list(logits.split([t - plen + 1 for _, t, plen in spans]))
