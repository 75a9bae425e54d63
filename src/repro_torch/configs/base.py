"""Architecture config system — the port's own copy of the JAX
package's ``repro/configs/base.py`` (no import of ``repro``).

One :class:`ArchConfig` per assigned architecture (exact numbers from the
assignment table).  Every config is selectable via ``--arch <id>`` in the
launchers (``python -m repro_torch.launch.serve``, ``.train``).  The port
runs the dense family (RMSNorm or LayerNorm, SwiGLU or GELU:
internlm2-1.8b, stablelm-1.6b, starcoder2-7b, command-r-plus-104b), MoE
(llama4-scout-17b-a16e, kimi-k2-1t-a32b), the attention-free RWKV6
(rwkv6-1.6b) and the Mamba2 hybrid (zamba2-7b); the other configs are kept so that names and reduced sizes
agree with the JAX package, and the model refuses them
(``NotImplementedError``).

Shape sets (assignment): each architecture is paired with
  train_4k     seq=4096,   global_batch=256   -> train_step
  prefill_32k  seq=32768,  global_batch=32    -> serve_prefill
  decode_32k   seq=32768,  global_batch=128   -> serve_step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq=524288, global_batch=1     -> serve_step; SUB-QUADRATIC
               archs only (zamba2, rwkv6).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # ---- style knobs ----
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"         # swiglu | gelu
    rope: bool = True
    qkv_bias: bool = False
    attn_out_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    # ---- MoE ----
    n_experts: int = 0
    top_k: int = 1
    moe_d_ff: int = 0
    n_dense_layers: int = 0     # leading dense layers (kimi-k2 style)
    shared_expert: bool = False
    moe_group_size: int = 512   # GShard dispatch group length
    capacity_factor: float = 1.25
    # ---- SSM / hybrid ----
    ssm_state: int = 0          # Mamba2 state dim (zamba2)
    ssm_head_dim: int = 64
    attn_every: int = 0         # hybrid: shared attn block every k layers
    rwkv: bool = False          # RWKV6 blocks instead of attention
    # ---- enc-dec (whisper) ----
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 4_096        # stub audio context (frame embeddings)
    # ---- modality frontend stubs ----
    frontend: str = "none"      # none | patches | frames
    n_patches: int = 256
    frontend_dim: int = 1024    # raw patch/frame embedding width
    # ---- numerics / memory policy ----
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    loss_chunk: int = 512       # chunked-vocab cross entropy (memory opt)
    attn_q_block: int = 1024    # the JAX package's jnp attention blocks
    #                             (the port's kernel picks its own tiles)
    attn_kv_block: int = 1024
    remat: bool = True          # activation checkpoint each layer
    fused_qkv: bool = True
    ssm_chunk: int = 256        # mamba2 SSD chunk length
    # ---- distribution hints (set per dry-run cell, not per arch) ----
    mesh_axes: tuple | None = None       # e.g. ("data","model")
    attn_partition: str = "auto"         # auto | seq (sequence-parallel
    #                                      attention via sharding hints)
    moe_partition: str = "auto"          # auto | tokens (pin expert
    #                                      activations to (E->model,
    #                                      tokens->data); gathers weights
    #                                      instead of reducing activations)
    ssm_partition: str = "auto"          # auto | tokens (pin mamba/rwkv
    #                                      intermediates: batch->data,
    #                                      heads/channels->model)

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def shapes(self) -> list[Shape]:
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"],
               SHAPES["decode_32k"]]
        if self.is_subquadratic:
            out.append(SHAPES["long_500k"])
        return out

    def skipped_shapes(self) -> dict[str, str]:
        if self.is_subquadratic:
            return {}
        return {"long_500k": "full-attention arch: 524k-token full "
                             "attention is out of scope per assignment"}

    # ---- parameter count (for MODEL_FLOPS = 6·N·D) -------------------
    def param_count(self, active_only: bool = False) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd, H, Hkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * (H * hd) + 2 * d * (Hkv * hd) + (H * hd) * d
        mlp_mult = 3 if self.act == "swiglu" else 2
        dense_mlp = mlp_mult * d * ff
        n = 0
        if self.rwkv:
            # rwkv6: time-mix (r,k,v,g,o + decay/bonus) ~ 5*d*d, channel-mix
            per = 5 * d * d + 2 * d * self.d_ff + d * self.d_ff // 2
            n += self.n_layers * per
        elif self.family == "hybrid":
            n_attn = self.n_layers // max(self.attn_every, 1)
            per_mamba = (2 * d * (2 * d + 2 * self.ssm_state)  # in_proj
                         + 2 * d * d                            # out/gate
                         + mlp_mult * d * ff // 2)
            n += self.n_layers * per_mamba
            n += 1 * (attn + dense_mlp)  # ONE shared attn block (reused)
        elif self.n_experts:
            eff = self.top_k if active_only else self.n_experts
            per_moe = attn + mlp_mult * d * self.moe_d_ff * eff
            if self.shared_expert:
                per_moe += mlp_mult * d * self.moe_d_ff
            n += (self.n_layers - self.n_dense_layers) * per_moe
            n += self.n_dense_layers * (attn + dense_mlp)
        else:
            n += self.n_layers * (attn + dense_mlp)
        if self.enc_dec:
            # encoder stack + decoder cross-attention
            n += self.n_enc_layers * (attn + dense_mlp)
            n += self.n_layers * attn  # cross-attn per decoder layer
        n += V * d  # embedding
        if not self.tie_embeddings:
            n += V * d
        return n

    # ---- reduced config for CPU smoke tests --------------------------
    def reduced(self) -> "ArchConfig":
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.attn_every else 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            < self.n_heads else 4,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.n_experts else 0,
            n_dense_layers=min(self.n_dense_layers, 1),
            moe_group_size=64,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state or self.rwkv else 64,
            attn_every=min(self.attn_every, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=64,
            n_patches=8,
            frontend_dim=64,
            loss_chunk=64,
            attn_q_block=64,
            attn_kv_block=64,
            param_dtype="float32",
            compute_dtype="float32",
        )


# ---------------------------------------------------------------------------
# the assigned architectures (exact assignment-table numbers)
# ---------------------------------------------------------------------------
ARCHS: dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


STARCODER2_7B = _reg(ArchConfig(
    name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
    n_heads=36, n_kv_heads=4, d_ff=18432, vocab=49152,
    norm="layernorm", act="gelu", rope=True, qkv_bias=True,
    attn_out_bias=True))

INTERNLM2_1_8B = _reg(ArchConfig(
    name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab=92544,
    norm="rmsnorm", act="swiglu", rope=True))

COMMAND_R_PLUS_104B = _reg(ArchConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=33792, vocab=256000,
    norm="layernorm", act="swiglu", rope=True, qkv_bias=False,
    tie_embeddings=True))  # no-bias; Cohere ties embeddings

STABLELM_1_6B = _reg(ArchConfig(
    name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=5632, vocab=100352,
    norm="layernorm", act="swiglu", rope=True))

ZAMBA2_7B = _reg(ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    norm="rmsnorm", act="swiglu", rope=True,
    ssm_state=64, ssm_head_dim=64, attn_every=6))

LLAMA4_SCOUT = _reg(ArchConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
    norm="rmsnorm", act="swiglu", rope=True,
    n_experts=16, top_k=1, moe_d_ff=8192, shared_expert=True))

KIMI_K2 = _reg(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=18432, vocab=163840,
    norm="rmsnorm", act="swiglu", rope=True,
    n_experts=384, top_k=8, moe_d_ff=2048, n_dense_layers=1,
    shared_expert=True))

INTERNVL2_76B = _reg(ArchConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256,
    norm="rmsnorm", act="swiglu", rope=True,
    frontend="patches", n_patches=256, frontend_dim=3200))  # InternViT-6B

WHISPER_MEDIUM = _reg(ArchConfig(
    name="whisper-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865,
    norm="layernorm", act="gelu", rope=False,
    enc_dec=True, n_enc_layers=24, enc_seq=4096,
    frontend="frames", frontend_dim=80, tie_embeddings=True))

RWKV6_1_6B = _reg(ArchConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536,
    norm="layernorm", rwkv=True, rope=False, ssm_head_dim=64))


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
