# Llama-family decoder-only LM in PyTorch, loaded from GGUF.
#
# Port of sherpa_vietnamese_asr_tpu/models/llama.py, the summarizer's
# in-process model (web_service/summarizer.py's "local" backend).
# models/gguf.py parses the checkpoint; this module maps the ggml tensor
# names onto an nn.Module (RMSNorm + rotary GQA attention + SwiGLU) with the
# JAX package's parameter names and [d_in, d_out] linears, and runs greedy
# generation over a KV cache preallocated on the model's device.
#
# The arithmetic is the JAX package's: the rotary embedding rotates the two
# halves of a head (not adjacent pairs), GQA repeats each KV head
# n_heads / n_kv_heads times, the mask is -1e9 before the softmax, and the
# output projection is tied to the embedding when the checkpoint has no
# output.weight. Two differences in schedule, not in values: the prefill
# runs the prompt's positions only (JAX pads it to max_seq, whose padded
# rows no valid position reads), and a step attends over the cache rows
# written so far (JAX masks the rest with -1e9, which the softmax turns into
# exact zeros). Full float32 on the card: .to(cuda) turns TF32 off
# (models.zipformer.use_full_fp32) and the forward refuses to run with it on.

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
from sherpa_vietnamese_asr_tpu_torch.models.zipformer import (
    _check_full_fp32,
    use_full_fp32,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 16
    ffn_dim: int = 5632
    rope_base: float = 10000.0
    rms_eps: float = 1e-5
    max_seq: int = 2048
    # gemma-style variants
    embed_scale: bool = False     # multiply embeddings by sqrt(dim)
    compute_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


TINY_LLAMA = LlamaConfig(vocab_size=96, dim=32, n_layers=2, n_heads=4,
                         n_kv_heads=2, ffn_dim=64, max_seq=96)

# Parameter name -> (d_in, d_out) of one layer's linears, x @ w.
_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _linear_shapes(cfg: LlamaConfig) -> dict:
    hd = cfg.head_dim
    return {"wq": (cfg.dim, cfg.n_heads * hd), "wk": (cfg.dim, cfg.n_kv_heads * hd),
            "wv": (cfg.dim, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, cfg.dim),
            "w_gate": (cfg.dim, cfg.ffn_dim), "w_up": (cfg.dim, cfg.ffn_dim),
            "w_down": (cfg.ffn_dim, cfg.dim)}


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attn_norm = nn.Parameter(torch.ones(cfg.dim, device=device))
        self.ffn_norm = nn.Parameter(torch.ones(cfg.dim, device=device))
        for name, shape in _linear_shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(torch.empty(shape, device=device)))


def _rms_norm(w, x, eps):
    v = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(v + eps) * w


def _rope_tables(pos, base, half):
    """(cos, sin), each [T, 1, half], of the rotary angles at positions pos
    [T]; one pair serves every layer's queries and keys."""
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=pos.device) / half)
    ang = pos[:, None].to(torch.float32) * freqs[None, :]  # [T, half]
    return torch.cos(ang)[:, None], torch.sin(ang)[:, None]


def _rotate(x, cos, sin):
    """x: [T, H, hd] rotated by _rope_tables' angles: the two halves of each
    head, as the JAX package does (not adjacent pairs)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rope(x, pos, base):
    """x: [T, H, hd]; pos: [T] absolute positions (JAX _rope)."""
    return _rotate(x, *_rope_tables(pos, base, x.shape[-1] // 2))


def _attention(lp, x, cfg, pos, rope, cache=None):
    """x: [T, D] at positions pos = 0..T-1, rope = _rope_tables(pos). With
    cache = (k_buf, v_buf) ([S_max, Hkv, hd], one layer's) the keys and
    values are also written at rows 0..T-1."""
    t = x.shape[0]
    hd = cfg.head_dim
    rep = cfg.n_heads // cfg.n_kv_heads
    q = _rotate((x @ lp.wq).view(t, cfg.n_heads, hd), *rope)
    k = _rotate((x @ lp.wk).view(t, cfg.n_kv_heads, hd), *rope)
    v = (x @ lp.wv).view(t, cfg.n_kv_heads, hd)
    if cache is not None:
        cache[0][:t] = k
        cache[1][:t] = v
    keys_r = k.repeat_interleave(rep, dim=1)  # [T, H, hd]
    vals_r = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("thd,shd->hts", q, keys_r) / math.sqrt(hd)
    mask = pos[None, :] > pos[:, None]  # causal
    scores = scores.masked_fill(mask[None], -1e9)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("hts,shd->thd", attn, vals_r).reshape(t, -1)
    return out @ lp.wo


def _ffn(lp, x, cfg):
    g = _rms_norm(lp.ffn_norm, x, cfg.rms_eps)
    return x + (F.silu(g @ lp.w_gate) * (g @ lp.w_up)) @ lp.w_down


def _block(lp, x, cfg, pos, rope, cache=None):
    x = x + _attention(lp, _rms_norm(lp.attn_norm, x, cfg.rms_eps), cfg, pos, rope, cache)
    return _ffn(lp, x, cfg)


def _step_block(lp, x, cfg, rope, pos, k_buf, v_buf):
    """_block for one token at position pos (rope: its _rope_tables) over
    cache rows 0..pos: its keys and values are written at row pos, and no
    mask is needed, a step having no later key."""
    hd = cfg.head_dim
    rep = cfg.n_heads // cfg.n_kv_heads
    h = _rms_norm(lp.attn_norm, x, cfg.rms_eps)
    q = _rotate((h @ lp.wq).view(1, cfg.n_heads, hd), *rope)
    k_buf[pos] = _rotate((h @ lp.wk).view(1, cfg.n_kv_heads, hd), *rope)[0]
    v_buf[pos] = (h @ lp.wv).view(cfg.n_kv_heads, hd)
    keys_r = k_buf[:pos + 1].repeat_interleave(rep, dim=1)
    vals_r = v_buf[:pos + 1].repeat_interleave(rep, dim=1)
    scores = torch.einsum("thd,shd->hts", q, keys_r) / math.sqrt(hd)
    attn = torch.softmax(scores, dim=-1)
    x = x + torch.einsum("hts,shd->thd", attn, vals_r).reshape(1, -1) @ lp.wo
    return _ffn(lp, x, cfg)


class Llama(nn.Module):
    """The JAX package's parameter tree as a module: tok_emb [V, D],
    out_norm [D], output [V, D] or None (tied to tok_emb), layers.i.* with
    [d_in, d_out] linears. Built on `device`, the card by default (raises
    without one); weights uninitialised (random_llama, load_gguf_llama and
    convert.llama_from_numpy fill them)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        device = model_device("cuda" if device is None else device)
        self.cfg = cfg
        self.tok_emb = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim, device=device))
        self.out_norm = nn.Parameter(torch.ones(cfg.dim, device=device))
        self.register_parameter("output", None)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device) for _ in range(cfg.n_layers))
        self.requires_grad_(False)
        if device.type == "cuda":
            use_full_fp32()

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def to(self, *args, **kwargs) -> "Llama":
        super().to(*args, **kwargs)
        if self.device.type == "cuda":
            use_full_fp32()
        return self.eval()

    def _ids(self, ids):
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _embed(self, ids):
        if self.device.type == "cuda":
            _check_full_fp32()
        x = self.tok_emb[ids]
        if self.cfg.embed_scale:
            x = x * math.sqrt(self.cfg.dim)
        return x

    def _logits(self, x):
        x = _rms_norm(self.out_norm, x, self.cfg.rms_eps)
        out_w = self.output if self.output is not None else self.tok_emb
        return x @ out_w.T

    def new_cache(self):
        """(k, v), each [n_layers, max_seq, n_kv_heads, head_dim] zeros on
        the model's device."""
        cfg = self.cfg
        shape = (cfg.n_layers, cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, device=self.device),
                torch.zeros(shape, device=self.device))

    @torch.no_grad()
    def forward(self, ids):
        """ids: [T] token ids -> logits [T, vocab], no cache
        (llama_forward)."""
        ids = self._ids(ids)
        pos = torch.arange(ids.shape[0], device=self.device)
        rope = _rope_tables(pos, self.cfg.rope_base, self.cfg.head_dim // 2)
        x = self._embed(ids)
        for lp in self.layers:
            x = _block(lp, x, self.cfg, pos, rope)
        return self._logits(x)

    @torch.no_grad()
    def prefill(self, ids):
        """The prompt's positions through every layer, their keys and values
        written into a new cache. Returns (logits at the last position
        [vocab], cache)."""
        ids = self._ids(ids)
        cache = self.new_cache()
        pos = torch.arange(ids.shape[0], device=self.device)
        rope = _rope_tables(pos, self.cfg.rope_base, self.cfg.head_dim // 2)
        x = self._embed(ids)
        for i, lp in enumerate(self.layers):
            x = _block(lp, x, self.cfg, pos, rope, (cache[0][i], cache[1][i]))
        return self._logits(x[-1:])[0], cache

    @torch.no_grad()
    def step(self, cache, pos, token):
        """One greedy decode step of `token` at absolute position `pos`;
        writes its keys and values into `cache` and returns logits
        [vocab]."""
        p = torch.full((1,), int(pos), dtype=torch.int64, device=self.device)
        rope = _rope_tables(p, self.cfg.rope_base, self.cfg.head_dim // 2)
        x = self._embed(int(token))[None]
        for i, lp in enumerate(self.layers):
            x = _step_block(lp, x, self.cfg, rope, int(pos), cache[0][i], cache[1][i])
        return self._logits(x)[0]


def random_llama(cfg: LlamaConfig, generator: torch.Generator | None = None,
                 seed: int = 0, device=None) -> Llama:
    """Random weights with the JAX package's init scheme
    (init_llama_params): tok_emb N(0, 0.02^2), norms one, linears
    N(0, 1/d_in), output tied. Values come from `generator` (a CPU
    generator seeded with `seed` when None), drawn on the CPU in a fixed
    order, so one seed gives the same weights on every device; the model
    goes to `device`, the card by default."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    model = Llama(cfg, device="cpu")
    model.tok_emb.normal_(generator=generator).mul_(0.02)
    for lp in model.layers:
        for name in _LINEARS:
            w = getattr(lp, name)
            w.normal_(generator=generator).mul_(1.0 / math.sqrt(w.shape[0]))
    return model.to(model_device("cuda" if device is None else device))


def generate(model: Llama, prompt_ids, max_new_tokens=256, eos_id=None):
    """Greedy generation. Returns the list of generated token ids (no
    prompt). A prompt that would not leave room for max_new_tokens keeps its
    last max_seq - max_new_tokens tokens (none when max_new_tokens >=
    max_seq: then, as in the JAX package, the first token is the argmax at
    the last position of an all-zero prompt of max_seq tokens, whose cache
    rows each step overwrites before reading); generation stops at eos_id or
    at the last position of the cache."""
    prompt = np.asarray(prompt_ids, np.int64)
    s_max = model.cfg.max_seq
    if len(prompt) + max_new_tokens > s_max:
        prompt = prompt[-(s_max - max_new_tokens):]
    if len(prompt):
        logits, cache = model.prefill(prompt)
    else:  # max_new_tokens >= s_max left no prompt: JAX's padded prefill
        logits, cache = model.prefill(np.zeros(s_max, np.int64))  # reads its last row
    out = []
    pos = len(prompt)
    token = int(torch.argmax(logits))
    for _ in range(max_new_tokens):
        if eos_id is not None and token == eos_id:
            break
        out.append(token)
        if pos >= s_max - 1:
            break
        logits = model.step(cache, pos, token)
        token = int(torch.argmax(logits))
        pos += 1
    return out


# ---------------------------------------------------------------------------
# GGUF loading
# ---------------------------------------------------------------------------

def config_from_gguf(meta) -> LlamaConfig:
    arch = meta.get("general.architecture", "llama")
    g = lambda key, default=None: meta.get(f"{arch}.{key}", default)  # noqa: E731
    n_heads = int(g("attention.head_count"))
    return LlamaConfig(
        vocab_size=len(meta.get("tokenizer.ggml.tokens", []))
        or int(g("vocab_size", 32000)),
        dim=int(g("embedding_length")),
        n_layers=int(g("block_count")),
        n_heads=n_heads,
        n_kv_heads=int(g("attention.head_count_kv", n_heads)),
        ffn_dim=int(g("feed_forward_length")),
        rope_base=float(g("rope.freq_base", 10000.0)),
        rms_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
        max_seq=min(int(g("context_length", 2048)), 4096),
        embed_scale=(arch == "gemma"),
    )


def gguf_params(tensors, cfg: LlamaConfig) -> dict:
    """ggml tensors (name -> numpy array) -> the JAX package's parameter
    tree of numpy arrays. ggml matrices are [out, in] row-major; x @ W wants
    [in, out]."""
    def lin(name):
        return np.ascontiguousarray(tensors[name].T)

    params = {
        "tok_emb": tensors["token_embd.weight"],
        "out_norm": tensors["output_norm.weight"],
        "output": tensors.get("output.weight"),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        b = f"blk.{i}"
        params["layers"].append({
            "attn_norm": tensors[f"{b}.attn_norm.weight"],
            "wq": lin(f"{b}.attn_q.weight"),
            "wk": lin(f"{b}.attn_k.weight"),
            "wv": lin(f"{b}.attn_v.weight"),
            "wo": lin(f"{b}.attn_output.weight"),
            "ffn_norm": tensors[f"{b}.ffn_norm.weight"],
            "w_gate": lin(f"{b}.ffn_gate.weight"),
            "w_up": lin(f"{b}.ffn_up.weight"),
            "w_down": lin(f"{b}.ffn_down.weight"),
        })
    return params


def load_gguf_llama(path, device=None):
    """GGUF file -> (Llama, LlamaConfig, tokenizer BpeModel, meta). The
    file is read and dequantised on the host; the model goes to `device`,
    the card by default (raises without one)."""
    from sherpa_vietnamese_asr_tpu_torch.models.convert import llama_from_numpy
    from sherpa_vietnamese_asr_tpu_torch.models.gguf import read_gguf
    from sherpa_vietnamese_asr_tpu_torch.utils.bpe import BpeModel

    data = read_gguf(path)
    meta, t = data["metadata"], data["tensors"]
    cfg = config_from_gguf(meta)
    model = llama_from_numpy(gguf_params(t, cfg), cfg,
                             device="cuda" if device is None else device)
    tokens = meta.get("tokenizer.ggml.tokens", [])
    scores = meta.get("tokenizer.ggml.scores", [0.0] * len(tokens))
    types = meta.get("tokenizer.ggml.token_type", [1] * len(tokens))
    tokenizer = BpeModel(list(zip(tokens, scores, types))) if tokens else None
    return model, cfg, tokenizer, meta


def detokenize(tokenizer, ids):
    """Token ids -> text (sentencepiece-style: ▁ = space, <0xNN> = byte)."""
    out = bytearray()
    for i in ids:
        piece = tokenizer.id_to_piece(int(i))
        if len(piece) == 6 and piece.startswith("<0x") and piece[-1] == ">":
            out += bytes([int(piece[3:5], 16)])
        else:
            out += piece.replace("▁", " ").encode("utf-8")
    return out.decode("utf-8", errors="replace").lstrip(" ")
