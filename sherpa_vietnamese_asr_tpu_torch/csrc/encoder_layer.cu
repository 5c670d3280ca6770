// One whole Zipformer2 encoder layer of the bfloat16 tier, as a short
// sequence of launches on the caller's stream.
//
// Replaces: sherpa_vietnamese_asr_tpu/ops/encoder_layer.py _layer_kernel
// (launchers _layer_pallas, encoder_layer_pallas; its streamed=True variant
// computes the same), the TPU kernel that runs one whole layer per batch
// element with the sequence and a [H*T_pad, T_pad] attention-weights scratch
// resident in VMEM. The plain twin is ops/encoder_layer.encoder_layer_plain.
//
// Order, as in the TPU kernel: attention weights from the pre-layer x, ff1,
// the nonlin attention on head 0, self-attention 1, conv 1, ff2, the mid
// bypass, self-attention 2, conv 2, ff3, BiasNorm, the final bypass. Rounding
// points kept: a linear's f32 sum is rounded to bf16 and its bf16 bias added
// in bf16; the swoosh output is rounded to bf16 before the second product;
// attended values are rounded to bf16 before out_proj; the nonlin y-gate is a
// bf16 product; the conv gate output is zeroed on rows >= lens and stored in
// bf16; the K-tap depthwise sum is f32; the residual stream is f32. Masked
// keys score -1e9, so a chunk with lens 0 gets uniform weights over all
// T_pad keys.
//
// Every product is hand-written. The 17 linears and the 3 attends of a layer
// run one warp-specialised kernel (product_kernel): a producer warp keeps
// TMA loads of A and B tiles in flight into a ring of shared-memory stages
// guarded by mbarriers; two consumer warpgroups run wgmma m64nNk16 (bf16 in,
// f32 sums) on the stages that have arrived; the epilogue runs from the
// accumulator registers with bf16x2 / float2 stores. The grid is persistent:
// each block walks tiles, so its producer loads the next tile while its
// consumers store this one. TMA cannot round f32 to bf16, so the f32
// residual stream keeps a bf16 shadow (x16) that the residual epilogue
// writes beside it; it holds exactly the values the products read
// (round-to-nearest-even). q.k and the positional band stay exact bf16
// products summed in f32 on the SIMT cores (attn_bf16_kernel).
//
// What bounds it on the H100: a block has 227 KB of shared memory where the
// TPU kernel held 22 MB of weights scratch in VMEM at stack 0, so the layer
// is split into launches and the attention weights live in a [B, H, T_pad,
// T_pad] bf16 workspace in device memory (177 MB at stack 0, B 8, T_pad
// 1664, H 4: written once by the score pass and streamed by the attends,
// 2.25 reads a layer, about 0.17 ms of HBM traffic at 3.35 TB/s). The linears
// are about 27 GFLOP a stack-0 layer (27 us at the bf16 tensor-core peak) and
// the attends byte-bound; the SIMT score pass (about 13 GFLOP of fp32) is the
// largest remaining part. The wrapper allocates every workspace and picks
// each product's tile plan (ops/encoder_layer.tile_plan); this file
// allocates nothing and launches the plans it is given.
//
// Attend widths: a self-attention head is one 16-column tile; the nonlin
// attend (one head of hna = 3 D / 4 columns) is one tile of up to 192
// columns (12 wgmma n16 chunks, 96 accumulators a thread), or, from 193 to
// 384 columns (Zipformer-68M's stacks 2-4: 288 and 384), two equal column
// tiles, numbered column-fastest like a linear's. Two tiles stream the [T,
// T] weight plane twice, but the two tiles of a row tile are neighbours in
// tile order and run on neighbouring blocks at the same time, so the second
// read mostly hits L2. The alternative, the columns split over the two
// consumer warpgroups, reads the weights once, but each warpgroup would then
// run both m64 row halves of its columns: a new warpgroup split, A
// addressing and epilogue map. The column tiles keep the 192-column
// instantiation, and every attend of 192 columns or fewer (all of
// Zipformer-30M) runs as before.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float swoosh_l(float x) {
  const float v = x - 4.f;
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))) - 0.08f * x - 0.035f;
}
__device__ __forceinline__ float swoosh_r(float x) {
  const float v = x - 1.f;
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))) - 0.08f * x - 0.313261687f;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

#define SVT_TRY(call)                   \
  do {                                  \
    const cudaError_t e_ = (call);      \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)

// ------------------------------------------------------------- products
// C(m, n) = sum_k A(m, k) B(k, n), bf16 operands, f32 sums. Epilogue on
// y = bf16(C) [+ bias in bf16]:
//   kStore:   out = y
//   kSwooshL: out = bf16(swoosh_l(y))
//   kYGate:   out = bf16(y * ygate)
//   kResid:   x_out = x_res + y, then with byp: x_orig + (x - x_orig) * clip(byp);
//             x16 = bf16(x_out), the stream's shadow for the next product
// Linears: A [M, K] bf16 row-major (K-major), B = W^T [N, K] (K-major), both
// in 128-byte swizzled tiles of 64 deep. Attends: A = weights [.., S, T]
// (MN-major: t contiguous), B = values [.., S, C] (MN-major: c contiguous);
// A in 128-byte swizzled 64 x 64 tiles, B in 32-byte swizzled chunks of 16
// columns (wgmma with both operands transposed).
enum Epi { kStore = 0, kSwooshL = 1, kYGate = 2, kResid = 3 };

constexpr int kBM = 128;                                  // two warpgroups of m64
constexpr int kBK = 64;                                   // a stage's depth
constexpr int kConsumerThreads = 256;
constexpr int kProductThreads = kConsumerThreads + 32;    // + the producer warp
constexpr int kATile = kBM * kBK * 2;                     // 16 KB a stage
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;                        // 227 KB a block
constexpr int kProducts = 20;                             // a layer's products
constexpr uint64_t kSw128 = 1, kSw32 = 3;                 // descriptor layouts

// A product's tile plan, chosen by the wrapper (ops/encoder_layer.tile_plan):
// rows a tile (kBM), columns a tile, wgmma width and ring stages.
struct Plan {
  int bm, bn, nw, stages;
};

int smem_bytes(int bn, int stages) {
  return 1024 + stages * (kATile + bn * kBK * 2) + 16 * stages;
}

struct ProdArgs {
  int M, N, K;        // rows and valid columns of one batch, depth
  int m_tiles, n_tiles, tiles, zdiv, nj, stages;
  int a_z1, a_z2, b_col;  // attends: A's (b, h) plane, B's column of head h
  // outputs are addressed by row z1 * c_rows + m and column z2 * c_cols + n
  long long c_rows, c_cols;
  const bf16* bias;  // [N] or null
  bf16* out;
  long long ldo;
  const bf16* ygate;
  long long ldy;
  float* x_out;
  const float* x_res;
  const float* x_orig;
  const float* byp;  // [N] or null
  bf16* x16;
  long long ldx;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), layout (1: 128-byte swizzle, 3: 32-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {  // at most N groups still running
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (its registers are only defined after the wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B over m64 x NW x k16; TR = 1 reads both operands MN-major.
template <int NW, int TR>
struct Wgmma;

template <int TR>
struct Wgmma<16, TR> {
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %11;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TR));
  }
};

template <int TR>
struct Wgmma<64, TR> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TR));
  }
};

// One pair of neighbouring output columns (col and N even).
template <int EPI>
__device__ __forceinline__ void store_pair(const ProdArgs& p, long long z1, long long z2,
                                           int row, int col, float a0, float a1) {
  if (row >= p.M || col < 0 || col >= p.N) return;
  float y0 = rbf(a0), y1 = rbf(a1);
  if (p.bias) {
    const float2 b = __bfloat1622float2(*reinterpret_cast<const bf162*>(p.bias + col));
    y0 = rbf(y0 + b.x);
    y1 = rbf(y1 + b.y);
  }
  const long long r = z1 * p.c_rows + row, c = z2 * p.c_cols + col;
  if (EPI == kStore) {
    *reinterpret_cast<bf162*>(p.out + r * p.ldo + c) = __floats2bfloat162_rn(y0, y1);
  } else if (EPI == kSwooshL) {
    *reinterpret_cast<bf162*>(p.out + r * p.ldo + c) =
        __floats2bfloat162_rn(swoosh_l(y0), swoosh_l(y1));
  } else if (EPI == kYGate) {
    const float2 g =
        __bfloat1622float2(*reinterpret_cast<const bf162*>(p.ygate + r * p.ldy + c));
    *reinterpret_cast<bf162*>(p.out + r * p.ldo + c) = __floats2bfloat162_rn(y0 * g.x, y1 * g.y);
  } else {
    const long long o = r * p.ldx + c;
    const float2 xr = *reinterpret_cast<const float2*>(p.x_res + o);
    float r0 = xr.x + y0, r1 = xr.y + y1;
    if (p.byp) {
      const float2 xo = *reinterpret_cast<const float2*>(p.x_orig + o);
      r0 = xo.x + (r0 - xo.x) * fminf(fmaxf(p.byp[c], 0.f), 1.f);
      r1 = xo.y + (r1 - xo.y) * fminf(fmaxf(p.byp[c + 1], 0.f), 1.f);
    }
    *reinterpret_cast<float2*>(p.x_out + o) = make_float2(r0, r1);
    *reinterpret_cast<bf162*>(p.x16 + o) = __floats2bfloat162_rn(r0, r1);
  }
}

// Tiles are numbered with the column tile fastest, then the row tile, then
// the batch z = z1 * zdiv + z2; block b takes tiles b, b + grid, ... A tile
// is nj chunks of NW columns: a linear's nj is MAXJ (a compile-time
// constant), an attend's p.nj <= MAXJ.
template <int NW, int MAXJ, int EPI, bool ATTEND>
__global__ void __launch_bounds__(kProductThreads, 1)
product_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
               const ProdArgs p) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms repeat every 1024 bytes: align every tile to it
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int nj = ATTEND ? p.nj : MAXJ;
  const int stage_bytes = kATile + nj * NW * kBK * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * stage_bytes);
  uint64_t* empty = full + p.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = (p.K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the bytes
      mbar_init(&empty[s], 2);  // one arrive from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {  // the producer warp: one thread issues
    if (lane != 0) return;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int nt = tile % p.n_tiles, mt = tile / p.n_tiles % p.m_tiles;
      const int z = tile / (p.n_tiles * p.m_tiles), z1 = z / p.zdiv, z2 = z % p.zdiv;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* sa = ring + stage * stage_bytes;
        uint8_t* sb = sa + kATile;
        mbar_expect_tx(&full[stage], stage_bytes);
        if (ATTEND) {
          const int plane = z1 * p.a_z1 + z2 * p.a_z2;
          tma_3d(sa, &tma, &full[stage], mt * kBM, kt * kBK, plane);
          tma_3d(sa + kATile / 2, &tma, &full[stage], mt * kBM + 64, kt * kBK, plane);
          // a box starts 16-byte aligned: at the head's column rounded down
          // to 8, plus the column tile's first column
          const int col = (z2 * p.b_col & ~7) + nt * nj * 16;
          for (int j = 0; j < nj; ++j)
            tma_3d(sb + j * 16 * kBK * 2, &tmb, &full[stage], col + 16 * j, kt * kBK, z1);
        } else {
          tma_2d(sa, &tma, &full[stage], kt * kBK, mt * kBM);
          tma_2d(sb, &tmb, &full[stage], kt * kBK, nt * nj * NW);
        }
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile. One
  // wgmma group stays in flight: a stage is released once the group after
  // it has been issued and its own has completed.
  const int wg = warp >> 2;
  float acc[MAXJ][NW / 2];
  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int nt = tile % p.n_tiles, mt = tile / p.n_tiles % p.m_tiles;
    const int z = tile / (p.n_tiles * p.m_tiles);
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint32_t a = smem_u32(ring + stage * stage_bytes) + wg * (kATile / 2);
      const uint32_t b = smem_u32(ring + stage * stage_bytes) + kATile;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) fence_regs(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int accumulate = kt > 0 || kk > 0;
        // A: K-major rows of 128 bytes (a k16 step is 32 bytes along the
        // row), or MN-major 64-wide rows, one per k (a k16 step is 16 rows).
        // The MN-major tiles are one swizzle atom wide, so both offsets are
        // the 8-row group stride.
        const uint64_t da = ATTEND ? smem_desc(a + kk * 16 * 128, 1024, 1024, kSw128)
                                   : smem_desc(a + kk * 32, 16, 1024, kSw128);
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) {
          if (j < nj) {
            const uint64_t db =
                ATTEND ? smem_desc(b + j * 16 * kBK * 2 + kk * 16 * 32, 256, 256, kSw32)
                       : smem_desc(b + j * NW * 128 + kk * 32, 16, 1024, kSw128);
            Wgmma<NW, ATTEND ? 1 : 0>::run(acc[j], da, db, accumulate);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      const int prev = stage == 0 ? p.stages - 1 : stage - 1;
      if (kt > 0 && (threadIdx.x & 127) == 0) mbar_arrive(&empty[prev]);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) fence_regs(acc[j]);
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[stage == 0 ? p.stages - 1 : stage - 1]);
    // Register i of chunk j: row +8 for (i / 2) odd, columns 8 (i / 4) +
    // 2 (lane % 4) + (i % 2) of the chunk (ops/encoder_layer.epilogue_map).
    // An attend's head h computed its columns from (h b_col) & ~7 on.
    const long long z1 = z / p.zdiv, z2 = z % p.zdiv;
    const int row0 = mt * kBM + wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int col0 = nt * nj * NW + 2 * (lane & 3) - (ATTEND ? (int)(z2 * p.b_col & 7) : 0);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      if (j < nj) {
#pragma unroll
        for (int i = 0; i < NW / 2; i += 2)
          store_pair<EPI>(p, z1, z2, row0 + 8 * ((i >> 1) & 1), col0 + j * NW + 8 * (i >> 2),
                          acc[j][i], acc[j][i + 1]);
      }
    }
  }
}

// Raises a kernel's dynamic shared-memory limit once per device.
cudaError_t allow_smem(const void* fn, unsigned* devices) {
  int dev = 0;
  SVT_TRY(cudaGetDevice(&dev));
  if ((*devices >> dev) & 1u) return cudaSuccess;
  SVT_TRY(cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit));
  *devices |= 1u << dev;
  return cudaSuccess;
}

template <int NW, int MAXJ, int EPI, bool ATTEND>
cudaError_t launch_product(const CUtensorMap& ma, const CUtensorMap& mb, const ProdArgs& p,
                           int sms, cudaStream_t st) {
  static unsigned allowed = 0;
  const void* fn = reinterpret_cast<const void*>(product_kernel<NW, MAXJ, EPI, ATTEND>);
  SVT_TRY(allow_smem(fn, &allowed));
  const int grid = p.tiles < sms ? p.tiles : sms;
  product_kernel<NW, MAXJ, EPI, ATTEND>
      <<<grid, kProductThreads, smem_bytes(p.nj * NW, p.stages), st>>>(ma, mb, p);
  return cudaGetLastError();
}

// A linear's tile is p.nj (1 to 4) chunks of 64 columns, fixed at compile time.
template <int EPI>
cudaError_t launch_linear(const CUtensorMap& ma, const CUtensorMap& mb, const ProdArgs& p,
                          int sms, cudaStream_t st) {
  switch (p.nj) {
    case 1: return launch_product<64, 1, EPI, false>(ma, mb, p, sms, st);
    case 2: return launch_product<64, 2, EPI, false>(ma, mb, p, sms, st);
    case 3: return launch_product<64, 3, EPI, false>(ma, mb, p, sms, st);
    default: return launch_product<64, 4, EPI, false>(ma, mb, p, sms, st);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 tensor map; libcuda's encoder is fetched through the runtime,
// so the library needs no link to libcuda. Boxes past the tensor's end read
// zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    SVT_TRY(cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                             cudaEnableDefault, &found));
#else
    SVT_TRY(cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found));
#endif
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool plan_ok(const Plan& pl, int max_chunks) {
  return pl.bm == kBM && pl.bn > 0 && pl.bn % pl.nw == 0 &&
         pl.bn / pl.nw <= max_chunks && pl.stages >= 2 && pl.stages <= kMaxStages &&
         smem_bytes(pl.bn, pl.stages) <= kSmemLimit;
}

// A linear: a [M, K] bf16 row-major times W, given as wt = W^T [N, K] bf16.
cudaError_t linear(const Plan& pl, int epi, const bf16* a, const bf16* wt, int M, int K, int N,
                   ProdArgs p, int sms, cudaStream_t st) {
  if (!plan_ok(pl, 4) || pl.nw != 64 || K % 8 != 0 || N % 2 != 0) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const cuuint64_t adims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t bdims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t pitch[1] = {(cuuint64_t)K * 2};
  const cuuint32_t abox[2] = {kBK, kBM}, bbox[2] = {kBK, (cuuint32_t)pl.bn};
  SVT_TRY(tensor_map(&ma, a, 2, adims, pitch, abox, CU_TENSOR_MAP_SWIZZLE_128B));
  SVT_TRY(tensor_map(&mb, wt, 2, bdims, pitch, bbox, CU_TENSOR_MAP_SWIZZLE_128B));
  p.M = M;
  p.N = N;
  p.K = K;
  p.zdiv = 1;
  p.m_tiles = (M + kBM - 1) / kBM;
  p.n_tiles = (N + pl.bn - 1) / pl.bn;
  p.tiles = p.m_tiles * p.n_tiles;
  p.nj = pl.bn / pl.nw;
  p.stages = pl.stages;
  if (epi == kStore) return launch_linear<kStore>(ma, mb, p, sms, st);
  if (epi == kSwooshL) return launch_linear<kSwooshL>(ma, mb, p, sms, st);
  return launch_linear<kResid>(ma, mb, p, sms, st);
}

// An attend over `batches` = B * zdiv planes: out[b, t, h * c_cols + c]
// (c < N) = sum_s w[b * a_z1 + h * a_z2][s][t] v[b][s][h * b_col + c], with
// w [planes, T, T] and v [B, T, vcols] bf16. kStore (the heads of a
// self-attention, N = vd <= 16, one tile) or kYGate (the nonlin head, N <=
// 384: one tile of up to 192 columns or two tiles of pl.bn each).
constexpr int kNonlinChunks = 12;  // 192 columns a tile
constexpr int kNonlinTiles = 2;

cudaError_t attend(const Plan& pl, int epi, const bf16* w, int planes, const bf16* v,
                   int vcols, int B, int T, int N, ProdArgs p, int sms, cudaStream_t st) {
  // head h's columns start (h b_col) % 8 into its tile (even: pairs stay whole)
  int reach = N;
  for (int h = 0; h < p.zdiv; ++h) reach = h * p.b_col % 8 + N > reach ? h * p.b_col % 8 + N : reach;
  const int n_tiles = pl.bn > 0 ? (reach + pl.bn - 1) / pl.bn : 0;
  if (!plan_ok(pl, epi == kYGate ? kNonlinChunks : 1) || pl.nw != 16 ||
      n_tiles > (epi == kYGate ? kNonlinTiles : 1) || N % 2 != 0 || p.b_col % 2 != 0 ||
      T % 8 != 0 || vcols % 8 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const cuuint64_t adims[3] = {(cuuint64_t)T, (cuuint64_t)T, (cuuint64_t)planes};
  const cuuint64_t astr[2] = {(cuuint64_t)T * 2, (cuuint64_t)T * T * 2};
  const cuuint64_t bdims[3] = {(cuuint64_t)vcols, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t bstr[2] = {(cuuint64_t)vcols * 2, (cuuint64_t)T * vcols * 2};
  const cuuint32_t abox[3] = {64, kBK, 1}, bbox[3] = {16, kBK, 1};
  SVT_TRY(tensor_map(&ma, w, 3, adims, astr, abox, CU_TENSOR_MAP_SWIZZLE_128B));
  SVT_TRY(tensor_map(&mb, v, 3, bdims, bstr, bbox, CU_TENSOR_MAP_SWIZZLE_32B));
  p.M = T;
  p.N = N;
  p.K = T;
  p.m_tiles = (T + kBM - 1) / kBM;
  p.n_tiles = n_tiles;
  p.tiles = p.m_tiles * n_tiles * B * p.zdiv;
  p.nj = pl.bn / 16;
  p.stages = pl.stages;
  p.c_rows = T;
  if (epi == kYGate) return launch_product<16, kNonlinChunks, kYGate, true>(ma, mb, p, sms, st);
  return launch_product<16, 1, kStore, true>(ma, mb, p, sms, st);
}

// ------------------------------------------------------ attention weights
// out[b, h, s, t] = softmax_s(q[t].k[s] + pq[t].poslin[h, T-1+s-t]) in bf16,
// keys s >= lens[b] scoring -1e9. One thread per query t, 128 queries per
// block; keys are staged in tiles of 64 beside the 64 + 127 position rows
// they need. Pass 1 keeps an online max and sum, pass 2 recomputes and writes
// keys-major, coalesced along t. q, k, pq are the bf16 projection's columns,
// so every product is exact in f32.
constexpr int kQueries = 128;
constexpr int kKeys = 64;
constexpr float kMasked = -1e9f;

template <int QD, int PD>
__global__ void __launch_bounds__(kQueries)
attn_bf16_kernel(const bf16* __restrict__ proj, const bf16* __restrict__ poslin,
                 const int* __restrict__ lens, bf16* __restrict__ out, int H,
                 int T, int prow) {
  __shared__ float s_k[kKeys][QD + 1];
  __shared__ float s_pos[kKeys + kQueries - 1][PD];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, t0 = blockIdx.x * kQueries, t = t0 + tid;
  const bool live = t < T;
  const int len = lens[b];
  const int P = H * (2 * QD + PD);
  const int n_rows = 2 * T - 1;
  const bf16* rows = proj + (size_t)b * T * P;
  const bf16* pb = poslin + (size_t)h * prow * PD;

  float qr[QD], pr[PD];
#pragma unroll
  for (int d = 0; d < QD; ++d) qr[d] = live ? bf2f(rows[(size_t)t * P + h * QD + d]) : 0.f;
#pragma unroll
  for (int d = 0; d < PD; ++d)
    pr[d] = live ? bf2f(rows[(size_t)t * P + 2 * H * QD + h * PD + d]) : 0.f;

  auto stage = [&](int s0) {
    for (int i = tid; i < kKeys * QD; i += kQueries) {
      const int s = i / QD, d = i % QD;
      s_k[s][d] = (s0 + s < T) ? bf2f(rows[(size_t)(s0 + s) * P + H * QD + h * QD + d]) : 0.f;
    }
    const int jmin = s0 + T - 1 - (t0 + kQueries - 1);
    for (int i = tid; i < (kKeys + kQueries - 1) * PD; i += kQueries) {
      const int r = i / PD, d = i % PD;
      const int j = jmin + r;
      s_pos[r][d] = (j >= 0 && j < n_rows) ? bf2f(pb[(size_t)j * PD + d]) : 0.f;
    }
  };
  auto score = [&](int s0, int si) {
    if (s0 + si >= len) return kMasked;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < QD; ++d) acc = fmaf(qr[d], s_k[si][d], acc);
    float pacc = 0.f;
    const int r = si + (kQueries - 1 - tid);
#pragma unroll
    for (int d = 0; d < PD; ++d) pacc = fmaf(pr[d], s_pos[r][d], pacc);
    return acc + pacc;
  };

  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < T; s0 += kKeys) {
    __syncthreads();
    stage(s0);
    __syncthreads();
    const int n = min(kKeys, T - s0);
    for (int si = 0; si < n; ++si) {
      const float x = score(s0, si);
      if (x > m) {
        l = l * expf(m - x) + 1.f;
        m = x;
      } else {
        l += expf(x - m);
      }
    }
  }

  bf16* ob = out + (size_t)bh * T * T;
  for (int s0 = 0; s0 < T; s0 += kKeys) {
    __syncthreads();
    stage(s0);
    __syncthreads();
    const int n = min(kKeys, T - s0);
    for (int si = 0; si < n; ++si) {
      const float x = score(s0, si);
      if (live) ob[(size_t)(s0 + si) * T + t] = __float2bfloat16(expf(x - m) / l);
    }
  }
}

template <int QD, int PD>
cudaError_t attn_weights(const bf16* proj, const bf16* poslin, const int* lens,
                         bf16* out, int B, int H, int T, int prow, cudaStream_t st) {
  const dim3 grid((T + kQueries - 1) / kQueries, B * H);
  attn_bf16_kernel<QD, PD><<<grid, kQueries, 0, st>>>(proj, poslin, lens, out, H, T, prow);
  return cudaGetLastError();
}

// ------------------------------------------------------ elementwise passes
// The layer input's bf16 shadow: x16 = bf16(x), two values a thread.
__global__ void shadow_kernel(const float2* __restrict__ x, bf162* __restrict__ x16,
                              long long n2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n2) x16[i] = __float22bfloat162_rn(x[i]);
}

// Nonlin gate: v[m, c] = bf16(tanh(s) * v) from pj = [s | v | y] (3 * hna).
__global__ void nonlin_gate_kernel(const bf16* __restrict__ pj, bf16* __restrict__ v,
                                   long long n, int hna) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long m = i / hna;
  const int c = (int)(i % hna);
  const bf16* row = pj + m * 3 * hna;
  v[i] = __float2bfloat16(tanhf(bf2f(row[c])) * bf2f(row[hna + c]));
}

// Conv module middle: hg = bf16(a * sigmoid(g)) from pj = [a | g] (2D),
// zero on rows >= lens and outside [0, T); out = bf16(swoosh_r(sum_k
// hg[t + k - halo] * dw[k] + dwb)) with the K-tap sum in f32.
constexpr int kConvRows = 64, kConvCh = 64, kConvThreads = 256;

__global__ void __launch_bounds__(kConvThreads)
dwconv_kernel(const bf16* __restrict__ pj, const bf16* __restrict__ dw,
              const bf16* __restrict__ dwb, const int* __restrict__ lens,
              bf16* __restrict__ out, int T, int D, int K) {
  extern __shared__ float smem[];
  const int halo = (K - 1) / 2, nrows = kConvRows + K - 1;
  float* s_hg = smem;                     // [nrows][kConvCh]
  float* s_dw = smem + nrows * kConvCh;   // [K][kConvCh]
  const int c0 = blockIdx.x * kConvCh, t0 = blockIdx.y * kConvRows, b = blockIdx.z;
  const int len = min(lens[b], T);
  for (int i = threadIdx.x; i < nrows * kConvCh; i += kConvThreads) {
    const int r = i / kConvCh, c = i % kConvCh;
    const int t = t0 - halo + r, gc = c0 + c;
    float v = 0.f;
    if (t >= 0 && t < len && gc < D) {
      const bf16* row = pj + ((size_t)b * T + t) * 2 * D;
      const float g = bf2f(row[D + gc]);
      v = rbf(bf2f(row[gc]) * (1.f / (1.f + expf(-g))));
    }
    s_hg[i] = v;
  }
  for (int i = threadIdx.x; i < K * kConvCh; i += kConvThreads) {
    const int k = i / kConvCh, c = i % kConvCh;
    s_dw[i] = (c0 + c < D) ? bf2f(dw[(size_t)k * D + c0 + c]) : 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x % kConvCh, gc = c0 + c;
  if (gc >= D) return;
  const float bias = bf2f(dwb[gc]);
  for (int r = threadIdx.x / kConvCh; r < kConvRows; r += kConvThreads / kConvCh) {
    const int t = t0 + r;
    if (t >= T) break;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += s_hg[(r + k) * kConvCh + c] * s_dw[k * kConvCh + c];
    out[((size_t)b * T + t) * D + gc] = __float2bfloat16(swoosh_r(acc + bias));
  }
}

// BiasNorm and the final bypass, one warp per row:
// out = x_orig + (x * exp(log_scale) / rms(x - bias) - x_orig) * clip(byp).
__global__ void biasnorm_bypass_kernel(const float* __restrict__ xw,
                                       const float* __restrict__ x_orig,
                                       const float* __restrict__ nbias,
                                       const float* __restrict__ log_scale,
                                       const float* __restrict__ byp,
                                       float* __restrict__ out, int M, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = xw + (size_t)row * D;
  float ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = xr[c] - nbias[c];
    ss += d * d;
  }
  ss = warp_sum(ss);
  const float scale = expf(log_scale[0]) / sqrtf(ss / D + 1e-12f);
  for (int c = lane; c < D; c += 32) {
    const size_t o = (size_t)row * D + c;
    const float xo = x_orig[o];
    out[o] = xo + (xr[c] * scale - xo) * fminf(fmaxf(byp[c], 0.f), 1.f);
  }
}

cudaError_t run_layer(const float* x, const int* lens, const bf16* pos,
                      const void* const* w, const void* const* wt, const Plan* plan,
                      float* out, bf16* proj, bf16* wts, bf16* wa, bf16* wb, bf16* wc,
                      float* ws_x, bf16* x16, int B, int T, int D, int H, int qd, int pd,
                      int vd, int hna, int ff1, int ff2, int ff3, int K, int pos_rows,
                      int sms, cudaStream_t st) {
  const int M = B * T, P = H * (2 * qd + pd), HV = H * vd;
  const auto* norm_bias = static_cast<const float*>(w[38]);
  const auto* log_scale = static_cast<const float*>(w[39]);
  const auto* byp_mid = static_cast<const float*>(w[40]);
  const auto* byp_out = static_cast<const float*>(w[41]);
  int next = 0;  // the plan of the next product, in launch order

  // the linear of operand pair (wi, wi + 1): weights W^T from wt, bias from w
  auto lin = [&](int epi, const bf16* a, int kdim, int wi, int n, ProdArgs p) {
    p.bias = static_cast<const bf16*>(w[wi + 1]);
    return linear(plan[next++], epi, a, static_cast<const bf16*>(wt[wi]), M, kdim, n, p, sms,
                  st);
  };
  // x_out = x_res + linear(a), optionally followed by the mid bypass; the
  // stream and its bf16 shadow
  auto resid = [&](const bf16* a, int kdim, int wi, const float* x_res, const float* byp) {
    ProdArgs p = {};
    p.x_out = ws_x;
    p.x_res = x_res;
    p.x_orig = x;
    p.byp = byp;
    p.x16 = x16;
    p.ldx = D;
    return lin(kResid, a, kdim, wi, D, p);
  };
  // linear of the stream's shadow x16 into a bf16 [M, n] buffer
  auto proj_from = [&](int wi, int n, bf16* o, int epi) {
    ProdArgs p = {};
    p.out = o;
    p.ldo = n;
    return lin(epi, x16, D, wi, n, p);
  };
  auto ff = [&](int wi, int f, const float* x_res, const float* byp) -> cudaError_t {
    SVT_TRY(proj_from(wi, f, wa, kSwooshL));
    return resid(wa, f, wi + 2, x_res, byp);
  };
  // attend: o[b, t, h*vd + c] = sum_s wts[b, h, s, t] v[b, s, h*vd + c]
  auto self_attn = [&](int wi) -> cudaError_t {
    SVT_TRY(proj_from(wi, HV, wa, kStore));
    ProdArgs p = {};
    p.zdiv = H;
    p.a_z1 = H;
    p.a_z2 = 1;
    p.b_col = vd;
    p.c_cols = vd;
    p.out = wb;
    p.ldo = HV;
    SVT_TRY(attend(plan[next++], kStore, wts, B * H, wa, HV, B, T, vd, p, sms, st));
    return resid(wb, HV, wi + 2, ws_x, nullptr);
  };
  auto conv = [&](int wi) -> cudaError_t {
    static unsigned allowed = 0;
    SVT_TRY(allow_smem(reinterpret_cast<const void*>(dwconv_kernel), &allowed));
    SVT_TRY(proj_from(wi, 2 * D, wa, kStore));
    const size_t smem = (size_t)(kConvRows + 2 * K - 1) * kConvCh * sizeof(float);
    const dim3 grid((D + kConvCh - 1) / kConvCh, (T + kConvRows - 1) / kConvRows, B);
    dwconv_kernel<<<grid, kConvThreads, smem, st>>>(
        wa, static_cast<const bf16*>(w[wi + 2]), static_cast<const bf16*>(w[wi + 3]), lens,
        wb, T, D, K);
    SVT_TRY(cudaGetLastError());
    return resid(wb, D, wi + 4, ws_x, nullptr);
  };

  // the layer input's shadow, read by the attention projection and ff1
  const long long n2 = (long long)M * D / 2;
  shadow_kernel<<<(unsigned)((n2 + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float2*>(x), reinterpret_cast<bf162*>(x16), n2);
  SVT_TRY(cudaGetLastError());
  // attention projection and the shared weights, from the pre-layer x
  SVT_TRY(proj_from(0, P, proj, kStore));
  if (qd == 32)
    SVT_TRY((attn_weights<32, 4>(proj, pos, lens, wts, B, H, T, pos_rows, st)));
  else
    SVT_TRY((attn_weights<16, 4>(proj, pos, lens, wts, B, H, T, pos_rows, st)));
  // ff1 reads the layer input and starts the residual stream ws_x
  SVT_TRY(ff(14, ff1, x, nullptr));
  // nonlin attention on head 0: gate, attend with the y-gate, out_proj
  SVT_TRY(proj_from(2, 3 * hna, wa, kStore));
  const long long n_gate = (long long)M * hna;
  nonlin_gate_kernel<<<(unsigned)((n_gate + 255) / 256), 256, 0, st>>>(wa, wb, n_gate, hna);
  SVT_TRY(cudaGetLastError());
  ProdArgs p = {};
  p.zdiv = 1;
  p.a_z1 = H;  // head 0 of batch element b
  p.out = wc;
  p.ldo = hna;
  p.ygate = wa + 2 * hna;
  p.ldy = 3 * hna;
  SVT_TRY(attend(plan[next++], kYGate, wts, B * H, wb, hna, B, T, hna, p, sms, st));
  SVT_TRY(resid(wc, hna, 4, ws_x, nullptr));
  SVT_TRY(self_attn(6));                // self-attention 1
  SVT_TRY(conv(26));                    // conv 1
  SVT_TRY(ff(18, ff2, ws_x, byp_mid));  // ff2, then the mid bypass
  SVT_TRY(self_attn(10));               // self-attention 2
  SVT_TRY(conv(32));                    // conv 2
  SVT_TRY(ff(22, ff3, ws_x, nullptr));  // ff3
  if (next != kProducts) return cudaErrorInvalidValue;
  biasnorm_bypass_kernel<<<(M * 32 + 255) / 256, 256, 0, st>>>(ws_x, x, norm_bias, log_scale,
                                                               byp_out, out, M, D);
  return cudaGetLastError();
}

#undef SVT_TRY

}  // namespace

// weights: a HOST array of 42 device pointers in the TPU kernel's operand
// order (see ZipformerLayer.kernel_layout): bf16 weights [d_in, d_out] and
// [n] biases, depthwise kernels [K, D], then f32 norm bias, log-scale, mid
// and final bypass scales. weights_t: a HOST array of 42 device pointers,
// the K-major copy [d_out, d_in] at each linear weight's slot (null
// elsewhere). plan: a HOST array of 20 x 4 ints (bm, bn, nw, stages), one
// tile plan per product in launch order (ops/encoder_layer.layer_products).
// poslin: [H, pos_rows, pd] bf16. Workspaces: ws_proj [B*T, H*(2qd+pd)],
// ws_w [B, H, T, T], ws_a [B*T, max(ff, 3hna, 2D, H*vd)], ws_b [B*T,
// max(hna, H*vd, D)], ws_c [B*T, max(hna, H*vd)], ws_x16 [B*T, D], all
// bf16, and ws_x [B*T, D] f32. sms: the card's multiprocessors (the
// products' persistent grid).
extern "C" int svt_encoder_layer_bf16(
    const float* x, const int* lens, const void* poslin, const void* const* w,
    const void* const* weights_t, const int* plan, float* out, void* ws_proj, void* ws_w,
    void* ws_a, void* ws_b, void* ws_c, float* ws_x, void* ws_x16, int B, int T, int D,
    int H, int qd, int pd, int vd, int hna, int ff1, int ff2, int ff3, int K, int pos_rows,
    int sms, void* stream) {
  if (B < 1 || T < 1 || D < 1 || H < 1 || vd < 1 || hna < 1 || K < 1 || K % 2 == 0 ||
      D % 2 != 0 || pd != 4 || (qd != 32 && qd != 16) || pos_rows < 2 * T - 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  return (int)run_layer(x, lens, static_cast<const bf16*>(poslin), w, weights_t,
                        reinterpret_cast<const Plan*>(plan), out,
                        static_cast<bf16*>(ws_proj), static_cast<bf16*>(ws_w),
                        static_cast<bf16*>(ws_a), static_cast<bf16*>(ws_b),
                        static_cast<bf16*>(ws_c), ws_x, static_cast<bf16*>(ws_x16), B, T, D,
                        H, qd, pd, vd, hna, ff1, ff2, ff3, K, pos_rows, sms,
                        (cudaStream_t)stream);
}
