// Per-expert GEMM over capacity buffers: y[e] = x[e] @ w[e], with rows at or
// past group_sizes[e] exactly 0.0.  Replaces the TPU kernel
// repro/kernels/grouped_gemm.py::grouped_gemm (body _gg_kernel).
//
//   f32, odd widths, din 0   : gg_fma    grid (n-tiles, m-tiles, E), 64x64x16
//                                        tiles, FMA only (true f32)
//   bf16, din and dout % 8   : gg_wgmma  persistent, TMA + wgmma
//
// gg_wgmma.  At mixtral's widths (4096 x 14336 experts) the work is bound by
// tensor-core operations once an expert holds a few hundred rows, and by the
// weights' bytes below that.  One block per SM walks the live output tiles,
// reading group_sizes itself (the host never reads it).  In a block, one
// producer warp keeps TMA loads of 128x64 X tiles and 64x256 W tiles in
// flight through a 4-stage ring with mbarriers; two consumer warpgroups of 64
// rows each run wgmma m64n256k16 on every stage (X K-major, W MN-major, both
// 128-byte swizzled), with registers moved to them by setmaxnreg.  The walk
// goes expert by expert, and within an expert over groups of m-tiles whose X
// fits 16 MB, each group swept panel by panel, so the 132 tiles in flight
// read each 2 MB W panel from HBM once per group and the group's X stays in
// L2 (gg_tile).  The tensor maps are 3-D, (E, C, din) and (E, din, dout): TMA
// zero-fills past each expert's own C and din, never reading the next
// expert.  The dead region (whole m-tiles past an expert's group size) is
// zeroed by three spare warps of every block with 16-byte stores, paced by
// the block's finished tiles so that its HBM traffic spreads over the
// products.  All offsets are 64-bit: E*C*dout passes 2^31 at full width.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include "wgmma.cuh"

// ---------------------------------------------------------------- FMA path --
template <typename T>
__global__ void __launch_bounds__(256)
gg_fma(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
       const int* __restrict__ group_sizes, int C, int din, int dout) {
  constexpr int BM = 64, BN = 64, BK = 16, NT = 256;
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = min(group_sizes[e], C);
  const T* xe = x + (int64_t)e * C * din;
  const T* we = w + (int64_t)e * din * dout;
  T* ye = y + (int64_t)e * C * dout;

  if (m0 >= rows) {
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int r = idx / BN, cc = idx % BN;
      if (m0 + r < C && n0 + cc < dout)
        ye[(int64_t)(m0 + r) * dout + n0 + cc] = from_f32<T>(0.f);
    }
    return;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < din; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int idx = tid + NT * i;
      const int r = idx / BK, kc = idx % BK;
      float val = 0.f;
      if (m0 + r < C && k0 + kc < din) val = to_f32(xe[(int64_t)(m0 + r) * din + k0 + kc]);
      As[kc][r] = val;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / NT; ++i) {
      const int idx = tid + NT * i;
      const int kr = idx / BN, nc = idx % BN;
      float val = 0.f;
      if (k0 + kr < din && n0 + nc < dout) val = to_f32(we[(int64_t)(k0 + kr) * dout + n0 + nc]);
      Bs[kr][nc] = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < dout)
        ye[(int64_t)row * dout + col] = from_f32<T>(row < rows ? acc[i][j] : 0.f);
    }
  }
}

// -------------------------------------------------------------- wgmma path --
namespace {

constexpr int GG_BM = 128, GG_BN = 256, GG_BK = 64, GG_STAGES = 4;
constexpr int GG_NT = 384;                          // producer + two consumer warpgroups
constexpr int GG_A_BYTES = GG_BM * GG_BK * 2;       // 16 KB: 128 rows of 128 bytes
constexpr int GG_B_BLOCK = GG_BK * 128;             // one 64-column block of W, 8 KB
constexpr int GG_B_BYTES = GG_BK * GG_BN * 2;       // 32 KB: four such blocks
constexpr int GG_STAGE_BYTES = GG_A_BYTES + GG_B_BYTES;
constexpr int GG_ZERO_THREADS = 96;                 // warps 1-3 of the producer warpgroup
constexpr int SMEM_MAX = 232448;

// Shared memory: 1024 bytes of alignment slack, the ring, a full and an empty
// barrier per stage, the running count of live m-tiles per expert and the
// count of tiles the block has finished.
size_t gg_smem_bytes(int E) {
  return 1024 + (size_t)GG_STAGES * GG_STAGE_BYTES + 2 * GG_STAGES * 8 + 4 * ((size_t)E + 1);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// One box of a 3-D tensor map into shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Live tile t of the walk -> (expert, first row, first column).  An expert's
// m-tiles are cut into groups of `mgroup`; within a group the 256-column
// panel is outer and the m-tile inner, so the tiles in flight share W panels
// and the group's X (at most 16 MB) stays in L2 while its panels go by.  `ex`
// is the caller's cursor: t only grows, so the scan over experts resumes.
__device__ __forceinline__ void gg_tile(int t, const int* mt_end, int n_tiles, int mgroup,
                                        int& ex, int& m0, int& n0) {
  while (mt_end[ex] * n_tiles <= t) ++ex;
  const int first = ex ? mt_end[ex - 1] : 0;
  const int mt = mt_end[ex] - first;
  const int local = t - first * n_tiles;
  const int grp = local / (mgroup * n_tiles);
  const int gsz = min(mgroup, mt - grp * mgroup);
  const int rem = local - grp * mgroup * n_tiles;
  n0 = (rem / gsz) * GG_BN;
  m0 = (grp * mgroup + rem % gsz) * GG_BM;
}

__device__ __forceinline__ int gg_rows(const int* group_sizes, int e, int C) {
  return min(max(group_sizes[e], 0), C);
}

__global__ void __launch_bounds__(GG_NT, 1)
gg_wgmma(const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_w,
         bf16* __restrict__ y, const int* __restrict__ group_sizes, int E, int C, int din,
         int dout, int mgroup) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GG_STAGES * GG_STAGE_BYTES);
  uint64_t* empty = full + GG_STAGES;
  int* mt_end = reinterpret_cast<int*>(empty + GG_STAGES);  // live m-tiles of experts 0..e
  volatile int* tiles_done = mt_end + E;                    // this block's finished tiles

  const int tid = threadIdx.x, wg = tid >> 7;
  const int n_tiles = (dout + GG_BN - 1) / GG_BN;
  const int nk = (din + GG_BK - 1) / GG_BK;
  if (tid == 0) {
    int total = 0;
    for (int e = 0; e < E; ++e) {
      total += (gg_rows(group_sizes, e, C) + GG_BM - 1) / GG_BM;
      mt_end[e] = total;
    }
    *tiles_done = 0;
    for (int s = 0; s < GG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int live_tiles = mt_end[E - 1] * n_tiles;

  if (wg == 0) {
    // ---- producer warpgroup: warp 0 loads, warps 1-3 zero the dead region
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int warp = tid >> 5;
    if (warp == 0) {
      if (tid == 0) {
        int stage = 0, ex = 0, m0, n0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < live_tiles; t += gridDim.x) {
          gg_tile(t, mt_end, n_tiles, mgroup, ex, m0, n0);
          for (int kt = 0; kt < nk; ++kt) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], GG_STAGE_BYTES);
            uint8_t* a = smem + stage * GG_STAGE_BYTES;
            tma_load_3d(a, &tmap_x, &full[stage], kt * GG_BK, m0, ex);
#pragma unroll
            for (int j = 0; j < GG_BN / 64; ++j)
              tma_load_3d(a + GG_A_BYTES + j * GG_B_BLOCK, &tmap_w, &full[stage], n0 + 64 * j,
                          kt * GG_BK, ex);
            if (++stage == GG_STAGES) { stage = 0; phase ^= 1; }
          }
        }
      }
    } else {
      // The dead region, paced by the consumers: this thread's share in
      // my_tiles + 1 equal parts, part i once the block has finished i tiles,
      // so that the zeros' HBM traffic spreads over the products instead of
      // taking the memory from the first tiles' loads.
      const int zt = tid - 32;
      const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
      const int64_t step = (int64_t)gridDim.x * GG_ZERO_THREADS;
      const int64_t v0 = (int64_t)blockIdx.x * GG_ZERO_THREADS + zt;
      const int my_tiles = (int)blockIdx.x < live_tiles
                               ? (live_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
                               : 0;
      int64_t mine = 0;
      for (int e = 0; e < E; ++e) {
        const int first = e ? mt_end[e - 1] : 0;
        const int live_end = min(C, (mt_end[e] - first) * GG_BM);
        const int64_t n_vec = (int64_t)(C - live_end) * dout / 8;
        if (n_vec > v0) mine += (n_vec - v0 + step - 1) / step;
      }
      const int64_t quota = (mine + my_tiles) / (my_tiles + 1);  // per part, rounded up
      int64_t left = quota;
      int part = 0;
      for (int e = 0; e < E; ++e) {
        const int first = e ? mt_end[e - 1] : 0;
        const int live_end = min(C, (mt_end[e] - first) * GG_BM);
        uint4* dst = reinterpret_cast<uint4*>(y + ((int64_t)e * C + live_end) * dout);
        const int64_t n_vec = (int64_t)(C - live_end) * dout / 8;
        for (int64_t v = v0; v < n_vec; v += step) {
          if (left == 0) {
            ++part;
            while (*tiles_done < part) __nanosleep(500);
            left = quota;
          }
          dst[v] = zero4;
          --left;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows (wg - 1) * 64 .. + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1, lane = tid & 31, wq = (tid >> 5) & 3;
    const int g = lane >> 2, c = lane & 3;
    int stage = 0, ex = 0, m0, n0;
    uint32_t phase = 0;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int t = blockIdx.x; t < live_tiles; t += gridDim.x) {
      gg_tile(t, mt_end, n_tiles, mgroup, ex, m0, n0);
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint8_t* a = smem + stage * GG_STAGE_BYTES;
        const uint8_t* b = a + GG_A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GG_BK / 16; ++kk)
          wgmma_m64n256k16_ss_bmn(acc, sw128_desc(a + cw * 64 * 128 + kk * 32, 16, 1024),
                                  sw128_desc(b + kk * 16 * 128, GG_B_BLOCK, 1024),
                                  kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == GG_STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      if (tid == 128) *tiles_done = *tiles_done + 1;  // pace the zero warps

      // rows at or past the group size store exactly 0.0
      const int rows = gg_rows(group_sizes, ex, C);
      bf16* ye = y + (int64_t)ex * C * dout;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + cw * 64 + wq * 16 + g + 8 * r;
        if (row >= C) continue;
        const bool live = row < rows;
        bf16* yr = ye + (int64_t)row * dout + n0 + 2 * c;
#pragma unroll
        for (int j = 0; j < GG_BN / 8; ++j) {
          if (n0 + 8 * j + 2 * c < dout) {
            const uint32_t val = live ? pack_bf16x2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]) : 0u;
            *reinterpret_cast<uint32_t*>(yr + 8 * j) = val;
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------- launch --
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so nothing links libcuda.
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 (E, rows, cols) row-major tensor, read in boxes of box_cols x box_rows
// with the 128-byte swizzle; out-of-range elements read as zero.
bool encode_3d(CUtensorMap* map, const void* base, int E, int rows, int cols, int box_cols,
               int box_rows) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The path and launch shape for a call, from the shapes, the dtype, the SM
// count and the pointers' alignment only (never from group_sizes).
// out: {path (0 fma, 1 wgmma), tile rows, tile cols, blocks, dynamic smem,
//       m-tiles per raster group}.
constexpr int64_t GG_GROUP_X_BYTES = 16 << 20;  // X rows a raster group keeps in L2
void plan(int dtype, int E, int C, int din, int dout, int n_sm, int aligned, int* out) {
  const size_t smem = gg_smem_bytes(E);
  if (dtype == 1 && din > 0 && din % 8 == 0 && dout % 8 == 0 && aligned && smem <= SMEM_MAX) {
    const int64_t tiles = (int64_t)E * ((C + GG_BM - 1) / GG_BM) * ((dout + GG_BN - 1) / GG_BN);
    const int64_t group = GG_GROUP_X_BYTES / ((int64_t)GG_BM * din * 2);
    out[0] = 1; out[1] = GG_BM; out[2] = GG_BN;
    out[3] = (int)(tiles < n_sm ? tiles : n_sm);
    out[4] = (int)smem;
    out[5] = (int)(group < 1 ? 1 : group);
    return;
  }
  out[0] = 0; out[1] = 64; out[2] = 64;
  out[3] = (int)((int64_t)((dout + 63) / 64) * ((C + 63) / 64) * E);
  out[4] = 0; out[5] = 0;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// The plan frontier_grouped_gemm follows for these arguments (out: 6 ints).
extern "C" void frontier_grouped_gemm_plan(int dtype, int E, int C, int din, int dout, int n_sm,
                                           int aligned, int* out) {
  plan(dtype, E, C, din, dout, n_sm, aligned, out);
}

// dtype: 0 = f32, 1 = bf16.  x (E,C,din), w (E,din,dout), y (E,C,dout), all
// contiguous; group_sizes int32 on the device.  Returns the cudaError_t.
extern "C" int frontier_grouped_gemm(const void* x, const void* w, void* y,
                                     const void* group_sizes, int dtype, int E, int C, int din,
                                     int dout, void* stream) {
  if (E <= 0 || C <= 0 || dout <= 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* gs = (const int*)group_sizes;
  const int aligned = (((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) & 15) == 0;
  const int n_sm = sm_count();
  if (n_sm <= 0) return (int)cudaGetLastError();
  int p[6];
  plan(dtype, E, C, din, dout, n_sm, aligned, p);
  if (p[0] == 1) {
    CUtensorMap tx, tw;
    if (!encode_3d(&tx, x, E, C, din, 64, GG_BM) || !encode_3d(&tw, w, E, din, dout, 64, GG_BK))
      return (int)cudaErrorNotSupported;
    cudaError_t err =
        cudaFuncSetAttribute(gg_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, p[4]);
    if (err != cudaSuccess) return (int)err;
    gg_wgmma<<<p[3], GG_NT, p[4], s>>>(tx, tw, (bf16*)y, gs, E, C, din, dout, p[5]);
    return (int)cudaGetLastError();
  }
  dim3 grid((dout + 63) / 64, (C + 63) / 64, E);
  if (dtype == 0)
    gg_fma<float><<<grid, 256, 0, s>>>((const float*)x, (const float*)w, (float*)y, gs, C, din,
                                       dout);
  else
    gg_fma<bf16><<<grid, 256, 0, s>>>((const bf16*)x, (const bf16*)w, (bf16*)y, gs, C, din,
                                      dout);
  return (int)cudaGetLastError();
}
