// Per-expert GEMM over capacity buffers: y[e] = x[e] @ w[e], with rows at or
// past group_sizes[e] exactly 0.0.
//
// Grid (n-tiles, m-tiles, E), a K loop inside the block with the accumulator
// in registers.  A block reads group_sizes[e] itself; an m-tile that lies
// wholly past the group size does no multiply and only stores zeros (the
// output buffer is uninitialised), so an imbalanced load costs its own live
// tiles: the ragged, wave-quantised cost the grouped-GEMM operator model
// predicts.  All offsets are 64-bit: E*C*dout passes 2^31 at full width.
//
//   f32                      : gg_fma  64x64x16 tiles, FMA only (true f32)
//   bf16, din and dout % 8   : gg_mma  128x128x32 tiles, mma.sync m16n8k16
//   bf16, other widths       : gg_fma
#include "common.cuh"

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

// ---------------------------------------------------------------- MMA path --
__global__ void __launch_bounds__(256)
gg_mma(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ y,
       const int* __restrict__ group_sizes, int C, int din, int dout) {
  constexpr int BM = 128, BN = 128, BK = 32, NT = 256;
  constexpr int LDA = BK + 8, LDB = BN + 8;
  __shared__ __align__(16) bf16 As[BM * LDA];
  __shared__ __align__(16) bf16 Bs[BK * LDB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps, 64 x 32 each
  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = min(group_sizes[e], C);
  const bf16* xe = x + (int64_t)e * C * din;
  const bf16* we = w + (int64_t)e * din * dout;
  bf16* ye = y + (int64_t)e * C * dout;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  if (m0 >= rows) {
    for (int idx = tid; idx < BM * BN / 8; idx += NT) {
      const int r = idx / (BN / 8), cv = (idx % (BN / 8)) * 8;
      if (m0 + r < C && n0 + cv < dout)
        *reinterpret_cast<uint4*>(ye + (int64_t)(m0 + r) * dout + n0 + cv) = zero4;
    }
    return;
  }

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int k0 = 0; k0 < din; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / NT; ++i) {
      const int vi = tid + NT * i;
      const int r = vi / (BK / 8), cv = (vi % (BK / 8)) * 8;
      uint4 val = zero4;
      if (m0 + r < C && k0 + cv < din)
        val = *reinterpret_cast<const uint4*>(xe + (int64_t)(m0 + r) * din + k0 + cv);
      *reinterpret_cast<uint4*>(As + r * LDA + cv) = val;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / NT; ++i) {
      const int vi = tid + NT * i;
      const int r = vi / (BN / 8), cv = (vi % (BN / 8)) * 8;
      uint4 val = zero4;
      if (k0 + r < din && n0 + cv < dout)
        val = *reinterpret_cast<const uint4*>(we + (int64_t)(k0 + r) * dout + n0 + cv);
      *reinterpret_cast<uint4*>(Bs + r * LDB + cv) = val;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], As + (wm * 64 + mt * 16 + (lane & 15)) * LDA + ks * 16 +
                               (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(b[np], Bs + (ks * 16 + (lane & 15)) * LDB + wn * 32 + np * 16 +
                                     (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16_16816(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                         b[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * r;
      if (row >= C) continue;
      const bool live = row < rows;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * c;
        if (col < dout) {
          const uint32_t val =
              live ? pack_bf16x2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]) : 0u;
          *reinterpret_cast<uint32_t*>(ye + (int64_t)row * dout + col) = val;
        }
      }
    }
  }
}

// dtype: 0 = f32, 1 = bf16.  x (E,C,din), w (E,din,dout), y (E,C,dout), all
// contiguous; group_sizes int32 on the device.  Returns the cudaError_t.
extern "C" int frontier_grouped_gemm(const void* x, const void* w, void* y,
                                     const void* group_sizes, int dtype, int E, int C, int din,
                                     int dout, void* stream) {
  if (E <= 0 || C <= 0 || dout <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* gs = (const int*)group_sizes;
  if (dtype == 1 && din % 8 == 0 && dout % 8 == 0) {
    dim3 grid((dout + 127) / 128, (C + 127) / 128, E);
    gg_mma<<<grid, 256, 0, s>>>((const bf16*)x, (const bf16*)w, (bf16*)y, gs, C, din, dout);
    return (int)cudaGetLastError();
  }
  dim3 grid((dout + 63) / 64, (C + 63) / 64, E);
  if (dtype == 0)
    gg_fma<float><<<grid, 256, 0, s>>>((const float*)x, (const float*)w, (float*)y, gs, C, din,
                                       dout);
  else if (dtype == 1)
    gg_fma<bf16><<<grid, 256, 0, s>>>((const bf16*)x, (const bf16*)w, (bf16*)y, gs, C, din,
                                      dout);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
