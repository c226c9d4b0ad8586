"""Model configuration system.

One frozen dataclass covers every assigned architecture family (dense /
GQA / MoE / SSM / hybrid / enc-dec / VLM); per-arch files instantiate it
with the exact published dimensions and register themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

_REGISTRY: dict = {}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # --- attention / CAMformer integration (first-class feature) ---
    # attn_mode was the seed-era spelling; the alias was deprecated and
    # is now REMOVED.  The field survives only so stale
    # replace(attn_mode=...) call sites fail with a clear migration
    # error instead of an opaque TypeError.
    attn_mode: Optional[str] = None  # REMOVED — always None
    # Canonical backend selection (core/backend.py registry names).
    attn_backend: Optional[str] = None
    # Per-layer backend policy: layer i runs layer_backends[i % len] —
    # hybrid models can mix realizations (e.g. sliding-window layers on
    # "dense", full-attention layers on "camformer").  Overrides
    # attn_backend/attn_mode when set.
    layer_backends: Optional[Tuple[str, ...]] = None
    k_top: int = 32
    group_size: int = 16
    stage1_k: int = 2
    use_kernel: bool = False
    # Paged decode realization (serving): "fused" runs each backend's
    # hand-written paged flash/CAM decode kernel (the kernel walks the
    # page table itself, streaming softmax — decode bytes/token
    # proportional to LIVE pages); "gather" keeps the plain page-gather +
    # masked attend as the selectable reference every kernel is pinned
    # against.
    paged_impl: str = "fused"
    # Sq > 1 paged realization (chunked-prefill and speculative-verify
    # chunks): "auto" (default) follows paged_impl, so the single switch
    # covers the whole serving path; "fused"/"gather" pin the chunk path
    # independently (the bench's --prefill-impl sweep axis).  CAMformer
    # chunks always gather — there is no fused Sq>1 CAM kernel yet; the
    # "hybrid" backend flash-scores its chunks through the dense pool
    # instead.
    prefill_impl: str = "auto"
    # Distributed CAM search: a B = 1 camformer decode searches a
    # sequence-sharded cache — local two-stage top-k per shard, then a
    # tiny candidate all-gather (k values/shard, not N scores) + global
    # top-k + partial-sum contextualization (core/backend.py
    # ``_distributed_attend`` over the ambient mesh; the sharded serving
    # steps of launch/steps.py split the cache itself).
    distributed_topk: bool = False
    # Chunked prefill (serving): process the prompt in chunks of this many
    # tokens, attending to the cache-so-far — bounds prefill activation
    # memory by the chunk instead of the full sequence.  0 = whole-sequence.
    prefill_chunk: int = 0
    # Self-speculative decoding (serving): per tick a drafter stack — the
    # SAME weights run with every layer forced to ``spec_backend`` —
    # proposes spec_k tokens from its own cheap paged cache, and the
    # target stack verifies all k+1 positions in one fused step.
    # 0 disables speculation (token-for-token today's decode loop).
    spec_k: int = 0
    spec_backend: str = "binary"
    # INTERNAL (models/transformer.lm_verify_paged): marks an Sq>1 pass
    # as a speculative VERIFY chunk — stateful backends (binary/camformer
    # k_scale) switch to sequential-decode semantics: per-query running
    # scales, and the chunk's per-position key means stashed for exact
    # accept-prefix rollback.  Never set directly.
    spec_verify: bool = False
    window: Optional[int] = None  # sliding-window layers (hybrid)

    # --- misc transformer knobs ---
    act: str = "silu"  # silu | gelu | geglu
    norm: str = "rms"  # rms | layer
    qkv_bias: bool = False
    rope_theta: float = 1e4
    use_rope: bool = True
    abs_pos: Optional[str] = None  # sinusoidal (whisper) | None
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    n_experts_padded: int = 0  # pad expert axis for EP divisibility (router
    #                            masks pads; e.g. granite 40 -> 48 on a
    #                            16-way model axis)

    # --- hybrid / ssm ---
    layer_pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    rnn_width: int = 0  # RG-LRU state width
    conv_width: int = 4
    rwkv_head_dim: int = 64

    # --- encoder-decoder / multimodal frontends (stubs per assignment) ---
    enc_layers: int = 0
    enc_len: int = 0  # fixed encoder length (whisper: 1500 frames)
    frontend: Optional[str] = None  # audio | vision
    n_patches: int = 0  # vision patch embeddings prepended to the sequence

    # --- numerics / compilation ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    scan_layers: bool = True
    remat: str = "full"  # full | none

    def __post_init__(self):
        if self.layer_backends is not None and not self.layer_backends:
            raise ValueError("layer_backends must be a non-empty tuple or "
                             "None (= uniform attn_backend)")
        if self.paged_impl not in ("fused", "gather"):
            raise ValueError(
                f"paged_impl={self.paged_impl!r} must be 'fused' (paged "
                "decode kernels) or 'gather' (plain page-gather "
                "reference)")
        if self.prefill_impl not in ("auto", "fused", "gather"):
            raise ValueError(
                f"prefill_impl={self.prefill_impl!r} must be 'auto' "
                "(follow paged_impl), 'fused' (Sq>1 paged flash kernel) "
                "or 'gather' (plain page-gather reference)")
        if self.spec_k < 0:
            raise ValueError(f"spec_k={self.spec_k} must be >= 0")
        if not self.spec_backend:
            raise ValueError(
                "spec_backend must name an attention backend "
                "(core/backend.py registry name, e.g. 'binary')")
        if self.attn_mode is not None:
            raise ValueError(
                f"attn_mode={self.attn_mode!r} was removed; set "
                f"attn_backend={self.attn_mode!r} instead "
                "(core/backend.py registry name), or layer_backends for a "
                "per-layer policy")

    # --- attention-backend resolution (every consumer goes through
    # these accessors) ---
    @property
    def backend(self) -> str:
        """Resolved default backend name.  A genuinely mixed layer policy
        has no single backend: consumers that cannot thread
        backend_for(layer) (encdec/rglru stacks, dry-run cells) must fail
        loudly rather than silently run every layer on the default."""
        if self.layer_backends:
            uniform = self.uniform_backend
            if uniform is None:
                raise ValueError(
                    "config has a mixed layer_backends policy "
                    f"{self.layer_backends}; use backend_for(layer) / "
                    "backend_names")
            return uniform
        return self.attn_backend or "dense"

    def backend_for(self, layer: int) -> str:
        """Typed accessor: the backend name of one layer (per-layer
        policy cycles layer_backends over the stack, like layer_pattern)."""
        if self.layer_backends:
            return self.layer_backends[layer % len(self.layer_backends)]
        return self.backend

    @property
    def backend_names(self) -> Tuple[str, ...]:
        """Backend name per layer, length n_layers."""
        return tuple(self.backend_for(i) for i in range(self.n_layers))

    @property
    def uniform_backend(self) -> Optional[str]:
        """The single backend name if every layer agrees, else None."""
        names = set(self.backend_names)
        return names.pop() if len(names) == 1 else None

    @property
    def prefill_paged_impl(self) -> str:
        """Effective Sq > 1 (prefill-chunk / verify) paged realization:
        prefill_impl, with "auto" following paged_impl."""
        return self.paged_impl if self.prefill_impl == "auto" \
            else self.prefill_impl

    @property
    def padded_experts(self) -> int:
        return self.n_experts_padded or self.n_experts

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 128 (kept from the reference layout); embedding /
        head params use this width, logits mask the pad columns."""
        return -(-self.vocab // 128) * 128

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, **overrides) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    return cfg.replace(**overrides) if overrides else cfg


def list_archs() -> list:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def smoke_config(name: str, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (shape-preserving
    ratios: GQA grouping, MoE top-k, layer pattern are kept)."""
    cfg = get_config(name)
    kv_ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_heads = 4
    n_kv = max(1, n_heads // kv_ratio)
    small = dict(
        n_layers=min(cfg.n_layers, 2 * max(1, len(cfg.layer_pattern) or 1)),
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=32,
        d_ff=96 if cfg.n_experts == 0 else 32,
        vocab=256,
        rnn_width=64 if cfg.rnn_width else 0,
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        enc_layers=min(cfg.enc_layers, 2),
        enc_len=min(cfg.enc_len, 16) if cfg.enc_len else 0,
        n_patches=min(cfg.n_patches, 8) if cfg.n_patches else 0,
        k_top=8,
        group_size=4,
        dtype="float32",
        param_dtype="float32",
    )
    small.update(overrides)
    return cfg.replace(**small)


# Assigned input shapes (seq_len, global_batch) per shape id.
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
