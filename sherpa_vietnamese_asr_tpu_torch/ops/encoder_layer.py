# Whole-layer Zipformer2 encoder kernel of the bfloat16 tier.
#
# Port of sherpa_vietnamese_asr_tpu/ops/encoder_layer.py. encoder_layer() is
# the kernel's wrapper: a CPU tensor runs the plain twin encoder_layer_plain;
# a CUDA tensor launches csrc/encoder_layer.cu (svt_encoder_layer_bf16) or
# raises. Both compute the TPU kernel's math with its rounding points:
#   * a linear is an f32 sum of products of bf16-rounded operands, rounded to
#     bf16, plus the bf16 bias added in bf16;
#   * the swoosh output is rounded to bf16 before a feed-forward's second
#     product, the attended values before out_proj, and the nonlin y-gate is
#     a bf16 product;
#   * the conv gate output is zeroed on rows >= lens and stored in bf16; the
#     K-tap depthwise sum is f32;
#   * attention weights are softmax over keys of q.k + pq.poslin[t_pad-1+s-t]
#     (masked keys score -1e9, so a chunk with lens 0 gets uniform weights
#     over all t_pad keys), stored keys-major in bf16;
#   * the residual stream, BiasNorm and both bypasses are f32.
# Products of bf16 values are exact in f32, so the twin is the TPU kernel's
# arithmetic up to summation order on any backend (on CUDA with TF32 off).
#
# The kernel runs a layer's 20 products (layer_products) through one
# warp-specialised wgmma kernel fed by TMA; tile_plan picks each product's
# tile and ring here, and epilogue_map / product_tiles mirror the kernel's
# walk over tiles and accumulator registers for the CPU tests.

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib

R = 128  # the sequence is zero-padded to a multiple of R, as in the JAX package
N_FLAT = 42
# Operand slots of the 17 linear weights [d_in, d_out] among the 42; the
# kernel reads their K-major copies [d_out, d_in] (KernelOperands.flat_t).
LINEAR_WEIGHTS = (0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 30, 32, 36)

# csrc/encoder_layer.cu product_kernel: 128-row tiles (two consumer
# warpgroups of wgmma m64), stages of 64 deep, 227 KB of shared memory a
# block. A linear's tile is one of LINEAR_BN columns wide, in m64n64k16
# steps; an attend's is up to SA_MAX_N or NONLIN_TILE_N columns in
# m64n16k16 steps (its values arrive as 16-column chunks), and a nonlin
# attend up to NONLIN_MAX_N columns wide takes two column tiles.
BM, BK = 128, 64
LINEAR_BN, LINEAR_NW, ATTEND_NW = (64, 128, 192, 256), 64, 16
MAX_STAGES = 8
SMEM_LIMIT = 232448
SA_MAX_N, NONLIN_TILE_N = 16, 192  # attend tile widths the kernel is built for
NONLIN_MAX_N = 2 * NONLIN_TILE_N   # the nonlin attend in at most two tiles

# Kernel launches of encoder_layer() on CUDA tensors.
launches = 0

_B16, _F32 = torch.bfloat16, torch.float32


@dataclasses.dataclass(frozen=True)
class Product:
    """One product of the layer: m rows (of one batch) x n valid columns,
    depth k, over `batches` = B * zdiv batches. An attend reads the keys-major
    weights as A and a value buffer as B; zdiv > 1 is a self-attention's
    heads (head h writes columns [h n, h n + n))."""
    name: str
    m: int
    n: int
    k: int
    batches: int = 1
    attend: bool = False
    zdiv: int = 1

    @property
    def flops(self):
        return 2 * self.batches * self.m * self.n * self.k


@dataclasses.dataclass(frozen=True)
class TilePlan:
    bm: int
    bn: int
    nw: int      # wgmma width: the tile is bn / nw instructions wide
    stages: int

    @property
    def smem_bytes(self):
        """The kernel's dynamic shared memory: 1 KB of alignment slack, the
        ring of A and B tiles and two mbarriers a stage."""
        return 1024 + self.stages * ((self.bm + self.bn) * BK * 2 + 16)


def layer_products(b, t_pad, d, h, qd, pd, vd, hna, ff1, ff2, ff3):
    """The 20 products of one layer in the kernel's launch order (the order
    of its plan argument)."""
    m, hv = b * t_pad, h * vd

    def lin(name, n, k):
        return Product(name, m, n, k)

    def att(name, n, heads):
        return Product(name, t_pad, n, t_pad, b * heads, True, heads)

    return (lin("attn_in", h * (2 * qd + pd), d),
            lin("ff1_in", ff1, d), lin("ff1_out", d, ff1),
            lin("nonlin_in", 3 * hna, d), att("nonlin_attend", hna, 1),
            lin("nonlin_out", d, hna),
            lin("sa1_in", hv, d), att("sa1_attend", vd, h), lin("sa1_out", d, hv),
            lin("conv1_in", 2 * d, d), lin("conv1_out", d, d),
            lin("ff2_in", ff2, d), lin("ff2_out", d, ff2),
            lin("sa2_in", hv, d), att("sa2_attend", vd, h), lin("sa2_out", d, hv),
            lin("conv2_in", 2 * d, d), lin("conv2_out", d, d),
            lin("ff3_in", ff3, d), lin("ff3_out", d, ff3))


def layer_shape(flat, x_shape, heads, qd, pd, vd):
    """layer_products' arguments for a layer with operands `flat` (the
    TPU kernel's 42) on x of shape [B, T_pad, D]."""
    b, t_pad, d = x_shape
    return (b, t_pad, d, heads, qd, pd, vd, flat[2].shape[1] // 3,  # nl_in_w: [D, 3 hna]
            flat[14].shape[1], flat[18].shape[1], flat[22].shape[1])


def tile_plan(product, sms=132):
    """The tile plan of one product on a card with `sms` multiprocessors.

    An attend of up to NONLIN_TILE_N columns takes them all in one tile
    (rounded up to the wgmma width 16): it streams the weights once. A wider
    nonlin attend (Zipformer-68M's 288 and 384) takes two equal tiles, each
    streaming the weights. A self-attention head's value box starts 16-byte
    aligned, at column h n rounded down to 8, so its columns sit
    head_shift(h, n) into the tile. A linear takes the width of
    LINEAR_BN with the least waves x (width + 64), the narrower on a tie: a
    tile's time grows with its width plus a fixed part (its A tile and
    epilogue), and the grid runs in waves of `sms` tiles. On an H100, at
    the Zipformer-30M linears, it picks the fastest width or one within
    11% of it (tools/product_sweep.py; PERF.md). The ring is as deep as
    shared memory holds, at most MAX_STAGES.
    """
    error = plan_error(product)
    if error:
        raise ValueError(f"encoder layer kernel: {error}")
    n = product.n
    if product.attend:
        reach = max(head_shift(h, n) + n for h in range(product.zdiv))
        tiles = -(-reach // NONLIN_TILE_N)
        bn, nw = -(-reach // (16 * tiles)) * 16, ATTEND_NW
    else:
        m_tiles = -(-product.m // BM) * product.batches
        bn = min(LINEAR_BN, key=lambda w: (-(-m_tiles * -(-n // w) // sms) * (w + 64), w))
        nw = LINEAR_NW
    stage = (BM + bn) * BK * 2 + 16
    return TilePlan(BM, bn, nw, min(MAX_STAGES, (SMEM_LIMIT - 1024) // stage))


def plan_error(product):
    """Why the kernel cannot take `product`, or None if it can: an attend
    is at most SA_MAX_N (a self-attention head, one tile) or NONLIN_MAX_N
    (the nonlin attend, one or two tiles) columns wide, even, and a
    self-attention's heads' columns fit one tile; a linear needs d_in a
    multiple of 8 and d_out even."""
    n, k = product.n, product.k
    if product.attend:
        limit = SA_MAX_N if product.zdiv > 1 else NONLIN_MAX_N
        if n > limit or n % 2 or product.m % 8 or (product.zdiv * n) % 8:
            return (f"attend {product.name} of width {n} (at most {limit}, even) "
                    f"over {product.m} rows")
        reach = max(head_shift(h, n) + n for h in range(product.zdiv))
        if -(-reach // 16) * 16 > limit:
            return (f"attend {product.name}: heads of width {n} reach column "
                    f"{reach} of a {limit}-column tile")
    elif k % 8 or n % 2:
        return (f"linear {product.name} needs d_in a multiple of 8 and d_out "
                f"even, got {k} -> {n}")
    return None


def head_shift(h, n):
    """Where head h's n columns start inside its attend tile."""
    return h * n % 8


def epilogue_map(nw, nj):
    """Mirror of product_kernel's epilogue: the (row, col) inside a BM x
    (nj * nw) tile of accumulator register i of wgmma chunk j in each of the
    256 consumer threads, as two [256, nj * nw / 2] tensors (register
    j * nw / 2 + i). Thread t is lane t % 32 of warp t // 32; warpgroup
    t // 128 owns rows 64 (t // 128) on, its warps 16 rows each (the m64nNk16
    accumulator layout)."""
    t = torch.arange(2 * 128)[:, None]
    reg = torch.arange(nj * nw // 2)[None, :]
    j, i = reg // (nw // 2), reg % (nw // 2)
    warp, lane = t // 32, t % 32
    row = (warp // 4) * 64 + (warp % 4) * 16 + lane // 4 + 8 * ((i // 2) % 2)
    col = j * nw + 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return row, col


def product_tiles(product, plan):
    """Mirror of product_kernel's walk: for each tile, in tile order, the
    output row and column that its first valid element goes to, its valid
    rows and columns, and the tile column of that first valid element (a
    self-attention head's head_shift). Column tiles are numbered fastest,
    for an attend too (a nonlin attend past NONLIN_TILE_N). Outputs: a
    linear's [m, n]; an attend's [B * m, zdiv * n]."""
    m_tiles = -(-product.m // plan.bm)
    n_tiles = -(-product.n // plan.bn)
    c_rows = product.m if product.attend else 0
    c_cols = product.n if product.zdiv > 1 else 0
    tiles = []
    for tile in range(m_tiles * n_tiles * product.batches):
        nt, mt = tile % n_tiles, tile // n_tiles % m_tiles
        z = tile // (n_tiles * m_tiles)
        z1, z2 = z // product.zdiv, z % product.zdiv
        m0, n0 = mt * plan.bm, nt * plan.bn
        shift = head_shift(z2, product.n) if product.zdiv > 1 else 0
        tiles.append((z1 * c_rows + m0, z2 * c_cols + n0, min(plan.bm, product.m - m0),
                      min(plan.bn, product.n - n0), shift))
    return tiles


@functools.lru_cache(maxsize=None)
def _plan_array(shape, sms):
    """The kernel's plan argument for one layer shape: a C int array of
    (bm, bn, nw, stages) for each product in launch order."""
    flat = [v for p in layer_products(*shape)
            for v in dataclasses.astuple(tile_plan(p, sms))]
    return (ctypes.c_int * len(flat))(*flat)


@functools.lru_cache(maxsize=None)
def _multiprocessors(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _dot16(a, w):
    """f32 product of bf16-rounded operands (exact products, f32 sums)."""
    return a.to(_B16).to(_F32) @ w.to(_B16).to(_F32)


def _linear16(a, w, b):
    """bf16(bf16(a @ w) + b): the TPU kernel's _linear16."""
    return (_dot16(a, w).to(_B16).to(_F32) + b.to(_F32)).to(_B16)


def _swoosh_l(x):
    v = x - 4.0
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs())) \
        - 0.08 * x - 0.035


def _swoosh_r(x):
    v = x - 1.0
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs())) \
        - 0.08 * x - 0.313261687


def rel_pos_scores(pq, poslin):
    """[B, H, S, T] f32 positional band: pq[b, t, h] . poslin[h, t_pad-1+s-t].

    pq: [B, T_pad, H, pd] bf16; poslin: [H, >= 2*T_pad-1, pd] bf16.
    """
    t_pad = pq.shape[1]
    ar = torch.arange(t_pad, device=pq.device)
    rows = poslin[:, t_pad - 1 + ar[:, None] - ar[None, :]]    # [H, S, T, pd]
    return torch.einsum("bthd,hstd->bhst", pq.to(_F32), rows.to(_F32))


def attention_weights_bf16(proj, poslin, lens, heads, qd, pd):
    """[B, H, S, T] bf16 keys-major weights from the bf16 projection
    proj [B, T_pad, H*(2qd+pd)] (q | k | pq)."""
    b, t_pad, _ = proj.shape
    q = proj[..., : heads * qd].reshape(b, t_pad, heads, qd)
    k = proj[..., heads * qd: 2 * heads * qd].reshape(b, t_pad, heads, qd)
    pq = proj[..., 2 * heads * qd:].reshape(b, t_pad, heads, pd)
    scores = torch.einsum("bshd,bthd->bhst", k.to(_F32), q.to(_F32))
    scores = scores + rel_pos_scores(pq, poslin)
    valid = torch.arange(t_pad, device=proj.device)[None, :] < lens[:, None]
    scores = torch.where(valid[:, None, :, None], scores, -1e9)
    return torch.softmax(scores, dim=2).to(_B16)


def encoder_layer_plain(flat, x, poslin, lens, heads, qd, pd, vd):
    """Plain twin of the kernel. x: [B, T_pad, D] f32; poslin [H, rows, pd]
    bf16; lens [B]. Returns [B, T_pad, D] f32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("encoder_layer_plain needs TF32 off on CUDA")
    (attn_in_w, attn_in_b, nl_in_w, nl_in_b, nl_out_w, nl_out_b,
     sa1_in_w, sa1_in_b, sa1_out_w, sa1_out_b,
     sa2_in_w, sa2_in_b, sa2_out_w, sa2_out_b,
     ff1_in_w, ff1_in_b, ff1_out_w, ff1_out_b,
     ff2_in_w, ff2_in_b, ff2_out_w, ff2_out_b,
     ff3_in_w, ff3_in_b, ff3_out_w, ff3_out_b,
     c1_in_w, c1_in_b, c1_dw, c1_dwb, c1_out_w, c1_out_b,
     c2_in_w, c2_in_b, c2_dw, c2_dwb, c2_out_w, c2_out_b,
     norm_bias, norm_logscale, byp_mid, byp_out) = flat
    b, t_pad, d = x.shape
    lens = lens.to(device=x.device, dtype=torch.long)
    x = x.to(_F32)
    x_orig = x
    w = attention_weights_bf16(_linear16(x, attn_in_w, attn_in_b), poslin,
                               lens, heads, qd, pd)

    def attend(h, v16):
        """[B, T, c] f32 = sum_s w[h][s, t] v16[s, :]."""
        return torch.einsum("bst,bsc->btc", w[:, h].to(_F32), v16.to(_F32))

    def ff(in_w, in_b, out_w, out_b, xi):
        h = _linear16(xi, in_w, in_b)
        return _linear16(_swoosh_l(h.to(_F32)), out_w, out_b).to(_F32)

    x = x + ff(ff1_in_w, ff1_in_b, ff1_out_w, ff1_out_b, x)

    hna = nl_in_w.shape[1] // 3
    pj = _linear16(x, nl_in_w, nl_in_b)
    v = (torch.tanh(pj[..., :hna].to(_F32)) * pj[..., hna:2 * hna].to(_F32)).to(_B16)
    o = (attend(0, v).to(_B16).to(_F32) * pj[..., 2 * hna:].to(_F32)).to(_B16)
    x = x + _linear16(o, nl_out_w, nl_out_b).to(_F32)

    def self_attn(in_w, in_b, out_w, out_b, xi):
        v = _linear16(xi, in_w, in_b)
        o = torch.cat([attend(h, v[..., h * vd:(h + 1) * vd]).to(_B16)
                       for h in range(heads)], dim=-1)
        return _linear16(o, out_w, out_b).to(_F32)

    x = x + self_attn(sa1_in_w, sa1_in_b, sa1_out_w, sa1_out_b, x)

    rows_valid = (torch.arange(t_pad, device=x.device)[None, :]
                  < lens[:, None])[..., None]

    def conv_mod(in_w, in_b, dw, dwb, out_w, out_b, xi):
        pj = _linear16(xi, in_w, in_b)
        hg = pj[..., :d].to(_F32) * torch.sigmoid(pj[..., d:].to(_F32))
        hg = torch.where(rows_valid, hg, 0.0).to(_B16).to(_F32)
        ksize = dw.shape[0]
        halo = (ksize - 1) // 2
        c = torch.nn.functional.pad(hg, (0, 0, halo, halo))
        acc = torch.zeros_like(hg)
        for k in range(ksize):
            acc = acc + c[:, k:k + t_pad] * dw[k].to(_F32)
        acc = _swoosh_r(acc + dwb.to(_F32))
        return _linear16(acc, out_w, out_b).to(_F32)

    x = x + conv_mod(c1_in_w, c1_in_b, c1_dw, c1_dwb, c1_out_w, c1_out_b, x)
    x = x + ff(ff2_in_w, ff2_in_b, ff2_out_w, ff2_out_b, x)
    x = x_orig + (x - x_orig) * torch.clamp(byp_mid, 0.0, 1.0)
    x = x + self_attn(sa2_in_w, sa2_in_b, sa2_out_w, sa2_out_b, x)
    x = x + conv_mod(c2_in_w, c2_in_b, c2_dw, c2_dwb, c2_out_w, c2_out_b, x)
    x = x + ff(ff3_in_w, ff3_in_b, ff3_out_w, ff3_out_b, x)

    dlt = x - norm_bias
    rms = torch.sqrt(torch.mean(dlt * dlt, dim=-1, keepdim=True) + 1e-12)
    x = x * (torch.exp(norm_logscale) / rms)
    return x_orig + (x - x_orig) * torch.clamp(byp_out, 0.0, 1.0)


def poslin_bf16(rev_pos, w_pos, heads):
    """[H, rows, pd] bf16: the reversed padded position table projected in
    f32 (outside the kernel, as in the JAX package), then rounded."""
    p = rev_pos.to(_F32) @ w_pos.to(_F32)
    return p.reshape(rev_pos.shape[0], heads, -1).permute(1, 0, 2) \
        .to(_B16).contiguous()


class KernelOperands:
    """A layer's kernel operands on one device, checked once per layout: the
    42 in the TPU kernel's order (flat, never changed), the K-major copies
    [d_out, d_in] of its linear weights (flat_t, None at the other slots:
    the products read W^T through TMA) and the two host arrays of their
    pointers."""

    def __init__(self, flat):
        if len(flat) != N_FLAT or flat[28].shape[0] % 2 != 1:
            raise ValueError("encoder layer kernel: 42 operands, odd conv kernel")
        self.device = flat[0].device
        for i, w in enumerate(flat):
            want = _F32 if i >= 38 else _B16
            if w.device != self.device or w.dtype != want or not w.is_contiguous():
                raise ValueError(f"encoder layer kernel: operand {i} must be "
                                 f"contiguous {want} on {self.device}")
        self.flat = flat
        self.flat_t = tuple(w.t().contiguous() if i in LINEAR_WEIGHTS else None
                            for i, w in enumerate(flat))
        self.ptrs = (ctypes.c_void_p * N_FLAT)(*[w.data_ptr() for w in flat])
        self.ptrs_t = (ctypes.c_void_p * N_FLAT)(*[None if w is None else w.data_ptr()
                                                   for w in self.flat_t])


def kernel_operands(layer, flat):
    """The layer's KernelOperands for flat, its current kernel_layout()
    operands: rebuilt when the layout is."""
    cached = getattr(layer, "_kernel_operands", None)
    if cached is None or cached.flat is not flat:
        cached = KernelOperands(flat)
        layer._kernel_operands = cached
    return cached


def _encoder_layer_cuda(ops, x, poslin, lens, h, qd, pd, vd, entry=None):
    """ops: the layer's KernelOperands. entry: another build's
    svt_encoder_layer_bf16 with this one's C arguments (chip_smoke.py's A/B
    against a parent checkout)."""
    global launches
    dev = x.device
    shape = layer_shape(ops.flat, x.shape, h, qd, pd, vd)
    b, t_pad, d, _, _, _, _, hna, ff1, ff2, ff3 = shape
    if (qd, pd) not in ((32, 4), (16, 4)):
        raise ValueError(f"encoder layer kernel is built for (qd, pd) in "
                         f"((32, 4), (16, 4)), got {(qd, pd)}")
    if ops.device != dev:
        raise ValueError(f"encoder layer kernel: operands on {ops.device}, x on {dev}")
    if x.dtype != _F32 or not x.is_contiguous() or x.data_ptr() % 16 or d % 2:
        raise ValueError("encoder layer kernel: x must be contiguous float32, "
                         "16-byte aligned, D even")
    if lens.shape != (b,):
        raise ValueError("encoder layer kernel: lens must be [B]")
    if poslin.dtype != _B16 or poslin.shape[0] != h \
            or poslin.shape[1] < 2 * t_pad - 1 or poslin.shape[2] != pd:
        raise ValueError("encoder layer kernel: poslin must be bf16 "
                         f"[{h}, >= {2 * t_pad - 1}, {pd}]")
    if b * h * t_pad * t_pad >= 2 ** 31 or b * t_pad * 4 * d >= 2 ** 31:
        raise ValueError("encoder layer kernel: shapes exceed int32 indexing")
    m = b * t_pad
    out = torch.empty_like(x)
    if m == 0:
        return out
    # Raises on a shape the product kernel does not take.
    sms = _multiprocessors(dev.index if dev.index is not None
                           else torch.cuda.current_device())
    plan = _plan_array(shape, sms)
    # Workspaces (the C code allocates nothing), carved from one allocation
    # on 256-byte boundaries: the bf16 projection q|k|pq, the keys-major
    # weights [B, H, T_pad, T_pad], three bf16 activation buffers, the f32
    # residual stream and its bf16 shadow.
    sizes = (2 * m * h * (2 * qd + pd), 2 * b * h * t_pad * t_pad,
             2 * m * max(ff1, ff2, ff3, 3 * hna, 2 * d, h * vd), 2 * m * max(hna, h * vd, d),
             2 * m * max(hna, h * vd), 4 * m * d, 2 * m * d)
    starts = [0]
    for size in sizes:
        starts.append(starts[-1] + -(-size // 256) * 256)
    ws = torch.empty(starts[-1], dtype=torch.uint8, device=dev)
    ws_proj, ws_w, ws_a, ws_b, ws_c, ws_x, ws_x16 = (ws.data_ptr() + o for o in starts[:-1])
    lens32 = lens.to(device=dev, dtype=torch.int32).contiguous()
    fn = entry or cuda_lib.library().svt_encoder_layer_bf16
    status = fn(
        x.data_ptr(), lens32.data_ptr(), poslin.data_ptr(),
        ctypes.cast(ops.ptrs, ctypes.c_void_p), ctypes.cast(ops.ptrs_t, ctypes.c_void_p),
        ctypes.cast(plan, ctypes.c_void_p), out.data_ptr(),
        ws_proj, ws_w, ws_a, ws_b, ws_c, ws_x, ws_x16,
        b, t_pad, d, h, qd, pd, vd, hna, ff1, ff2, ff3, ops.flat[28].shape[0],
        poslin.shape[1], sms, cuda_lib.stream(dev))
    cuda_lib.check(status, "svt_encoder_layer_bf16")
    launches += 1
    return out


def layer_poslin(layer, rev_pos, w_pos):
    """poslin_bf16 of the layer, kept while rev_pos (the same tensor, not
    changed in place) and w_pos (from the layer's kernel_layout()) stay: the
    encoder passes one rev_pos per stack shape, so a layer projects it once,
    not per call."""
    cached = getattr(layer, "_poslin", None)
    if cached is None or cached[0] is not rev_pos or cached[1] != rev_pos._version \
            or cached[2] is not w_pos:
        cached = (rev_pos, rev_pos._version, w_pos, poslin_bf16(rev_pos, w_pos, layer.heads))
        layer._poslin = cached
    return cached[3]


def encoder_layer(layer, x, rev_pos, lens):
    """One Zipformer2 layer through the whole-layer kernel.

    layer: models.zipformer.ZipformerLayer; x: [B, T_pad, D] float32 with
    T_pad % 128 == 0 (padded rows finite, zeros from padding); rev_pos:
    [2*T_pad-1+128, pos_dim] from zipformer._padded_rev_pos_emb; lens: [B]
    valid frames. Returns [B, T_pad, D] float32.

    CPU tensors run the plain twin; CUDA tensors launch the kernel.
    """
    cfg = layer.cfg
    flat, w_pos = layer.kernel_layout()
    poslin = layer_poslin(layer, rev_pos, w_pos)
    args = (x, poslin, lens, layer.heads, cfg.query_head_dim,
            cfg.pos_head_dim, cfg.value_head_dim)
    with torch.no_grad():
        if x.device.type == "cpu":
            return encoder_layer_plain(flat, *args)
        if x.device.type != "cuda":
            raise ValueError(f"encoder_layer: unsupported device {x.device}")
        # The host span of one layer (tools/profile_slice reads it).
        with torch.profiler.record_function("svt_encoder_layer"):
            return _encoder_layer_cuda(kernel_operands(layer, flat), *args)
