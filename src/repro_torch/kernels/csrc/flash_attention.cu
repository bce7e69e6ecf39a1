// Forward attention softmax(q k^T * scale + mask) v by online softmax, GQA,
// causal (top-left aligned: q_pos >= k_pos) and sliding-window masks.
//
// One block owns one (batch, head, q-tile) and loops over the KV tiles that
// can hold an unmasked key; the running (m, l, acc) never leave registers.
// Ragged S and T are masked on load from the caller's strided tensors, so no
// padded or transposed copy is made.  The head dim arrives padded to 128 or
// 256 and q arrives pre-scaled so that `scale` is that of the padded dim.
//
//   f32  : flash_fwd_fma  32x32 tiles, FMA only (true f32)
//   bf16 : flash_fwd_mma  64x64 tiles, mma.sync m16n8k16, f32 accumulate
#include "common.cuh"

struct AttnStrides {
  int64_t q_b, q_s, q_h;
  int64_t k_b, k_t, k_h;
  int64_t v_b, v_t, v_h;
  int64_t o_b, o_s, o_h;
};

// First and one-past-last key position a q-tile starting at q0 can see.
__device__ __forceinline__ void kv_range(int q0, int bq, int bk, int Tk, int causal,
                                         int window, int* k_lo, int* k_hi) {
  int hi = Tk;
  if (causal) hi = min(Tk, q0 + bq);
  int lo = 0;
  if (window) {
    int first = q0 - window + 1;
    if (first > 0) lo = (first / bk) * bk;
  }
  *k_lo = lo;
  *k_hi = hi;
}

// ---------------------------------------------------------------- FMA path --
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_fwd_fma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int S, int Tk, int H, int K, int nq, AttnStrides st,
              float scale, int causal, int window) {
  constexpr int BQ = 32, BK = 32, LD = HD + 4, NT = 256;
  constexpr int VEC = Vec16<T>::N;
  constexpr int NJ = HD / 32;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;            // BQ x LD
  float* Ks = Qs + BQ * LD;      // BK x LD
  float* Vs = Ks + BK * LD;      // BK x HD
  float* Ps = Vs + BK * HD;      // BQ x BK

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int iq = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int b = bh / H, h = bh % H, kvh = h / (H / K);
  const int q0 = iq * BQ;
  const T* qb = q + (int64_t)b * st.q_b + (int64_t)h * st.q_h;
  const T* kb = k + (int64_t)b * st.k_b + (int64_t)kvh * st.k_h;
  const T* vb = v + (int64_t)b * st.v_b + (int64_t)kvh * st.v_h;
  T* ob = o + (int64_t)b * st.o_b + (int64_t)h * st.o_h;

  for (int idx = tid; idx < BQ * HD / VEC; idx += NT) {
    const int r = idx / (HD / VEC), c = (idx % (HD / VEC)) * VEC;
    float tmp[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) tmp[i] = 0.f;
    if (q0 + r < S) Vec16<T>::load(qb + (int64_t)(q0 + r) * st.q_s + c, tmp);
#pragma unroll
    for (int i = 0; i < VEC; ++i) Qs[r * LD + c + i] = tmp[i];
  }

  float m_i[4], l_i[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int k_lo, k_hi;
  kv_range(q0, BQ, BK, Tk, causal, window, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * HD / VEC; idx += NT) {
      const int r = idx / (HD / VEC), c = (idx % (HD / VEC)) * VEC;
      float tk[VEC], tv[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) { tk[i] = 0.f; tv[i] = 0.f; }
      if (k0 + r < Tk) {
        Vec16<T>::load(kb + (int64_t)(k0 + r) * st.k_t + c, tk);
        Vec16<T>::load(vb + (int64_t)(k0 + r) * st.v_t + c, tv);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        Ks[r * LD + c + i] = tk[i];
        Vs[r * HD + c + i] = tv[i];
      }
    }
    __syncthreads();

    // scores: warp w owns rows 4w..4w+3, lane owns key column `lane`
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float4* kr = reinterpret_cast<const float4*>(Ks + lane * LD);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = kr[d4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qq = reinterpret_cast<const float4*>(Qs + (warp * 4 + i) * LD)[d4];
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + warp * 4 + i;
      bool ok = (qpos < S) && (kpos < Tk);
      if (causal) ok = ok && (qpos >= kpos);
      if (window) ok = ok && ((qpos - kpos) < window);
      const float sv = ok ? s[i] * scale : NEG_INF;
      const float m_new = fmaxf(m_i[i], warp_max(sv));
      // a row with no valid key yet keeps m == NEG_INF: its p and alpha are 0
      const float p = (m_new == NEG_INF) ? 0.f : expf(sv - m_new);
      const float alpha = (m_i[i] == NEG_INF) ? 0.f : expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + warp_sum(p);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      Ps[(warp * 4 + i) * BK + lane] = p;
    }
    __syncwarp();

    // acc += P V: lane owns head-dim columns lane, lane+32, ...
    for (int c = 0; c < BK; ++c) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * HD + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(warp * 4 + i) * BK + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + warp * 4 + i;
    if (qpos < S) {
      const float denom = (l_i[i] == 0.f) ? 1.f : l_i[i];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ob[(int64_t)qpos * st.o_s + lane + 32 * j] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

// ---------------------------------------------------------------- MMA path --
template <int HD>
__global__ void __launch_bounds__(128)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int S, int Tk, int H,
              int K, int nq, AttnStrides st, float scale, int causal, int window) {
  constexpr int BQ = 64, BK = 64, LD = HD + 8, NT = 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // BQ x LD
  bf16* Ks = Qs + BQ * LD;                        // BK x LD
  bf16* Vs = Ks + BK * LD;                        // BK x LD

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int iq = blockIdx.x % nq;
  const int bh = blockIdx.x / nq;
  const int b = bh / H, h = bh % H, kvh = h / (H / K);
  const int q0 = iq * BQ;
  const bf16* qb = q + (int64_t)b * st.q_b + (int64_t)h * st.q_h;
  const bf16* kb = k + (int64_t)b * st.k_b + (int64_t)kvh * st.k_h;
  const bf16* vb = v + (int64_t)b * st.v_b + (int64_t)kvh * st.v_h;
  bf16* ob = o + (int64_t)b * st.o_b + (int64_t)h * st.o_h;

  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < BQ * HD / 8; idx += NT) {
    const int r = idx / (HD / 8), cv = (idx % (HD / 8)) * 8;
    uint4 val = zero4;
    if (q0 + r < S) val = *reinterpret_cast<const uint4*>(qb + (int64_t)(q0 + r) * st.q_s + cv);
    *reinterpret_cast<uint4*>(Qs + r * LD + cv) = val;
  }

  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  float oacc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;

  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0 and row0 + 8

  int k_lo, k_hi;
  kv_range(q0, BQ, BK, Tk, causal, window, &k_lo, &k_hi);
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * HD / 8; idx += NT) {
      const int r = idx / (HD / 8), cv = (idx % (HD / 8)) * 8;
      uint4 kvv = zero4, vvv = zero4;
      if (k0 + r < Tk) {
        kvv = *reinterpret_cast<const uint4*>(kb + (int64_t)(k0 + r) * st.k_t + cv);
        vvv = *reinterpret_cast<const uint4*>(vb + (int64_t)(k0 + r) * st.v_t + cv);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + cv) = kvv;
      *reinterpret_cast<uint4*>(Vs + r * LD + cv) = vvv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK keys
    float sacc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, Ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                             ((lane >> 3) & 1) * 8);
        mma_bf16_16816(sacc[2 * np], a, bfr[0], bfr[1]);
        mma_bf16_16816(sacc[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }

#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row0 + ((e >> 1) << 3);
        const int kpos = k0 + nt * 8 + 2 * c + (e & 1);
        bool ok = (qpos < S) && (kpos < Tk);
        if (causal) ok = ok && (qpos >= kpos);
        if (window) ok = ok && ((qpos - kpos) < window);
        sacc[nt][e] = ok ? sacc[nt][e] * scale : NEG_INF;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mc = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
        mc = fmaxf(mc, fmaxf(sacc[nt][2 * r], sacc[nt][2 * r + 1]));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_new = fmaxf(m_i[r], mc);
      const float alpha = (m_i[r] == NEG_INF) ? 0.f : __expf(m_i[r] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = (m_new == NEG_INF) ? 0.f : __expf(sacc[nt][e] - m_new);
          sacc[nt][e] = p;
          rowsum += p;
        }
      }
      l_i[r] = l_i[r] * alpha + rowsum;   // partial over this thread's columns
      m_i[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        oacc[dt][2 * r] *= alpha;
        oacc[dt][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P fed from the score accumulators as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(sacc[2 * kk][0], sacc[2 * kk][1]);
      a[1] = pack_bf16x2(sacc[2 * kk][2], sacc[2 * kk][3]);
      a[2] = pack_bf16x2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      a[3] = pack_bf16x2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, Vs + (kk * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16_16816(oacc[2 * dp], a, bfr[0], bfr[1]);
        mma_bf16_16816(oacc[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / ((l == 0.f) ? 1.f : l);
    const int qpos = row0 + 8 * r;
    if (qpos < S) {
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)qpos * st.o_s + dt * 8 + 2 * c) =
            __floats2bfloat162_rn(oacc[dt][2 * r] * inv, oacc[dt][2 * r + 1] * inv);
      }
    }
  }
}

// ------------------------------------------------------------------- launch --
template <typename T, int HD>
static int launch_fma(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int Tk, int H, int K, AttnStrides st, float scale, int causal,
                      int window, cudaStream_t stream) {
  constexpr int BQ = 32, BK = 32;
  const size_t smem = sizeof(float) * (BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * BK);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_fma<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + BQ - 1) / BQ;
  flash_fwd_fma<T, HD><<<(unsigned)((int64_t)B * H * nq), 256, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, Tk, H, K, nq, st, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int HD>
static int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int Tk, int H, int K, AttnStrides st, float scale, int causal,
                      int window, cudaStream_t stream) {
  constexpr int BQ = 64, BK = 64;
  const size_t smem = sizeof(bf16) * (BQ + 2 * BK) * (HD + 8);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + BQ - 1) / BQ;
  flash_fwd_mma<HD><<<(unsigned)((int64_t)B * H * nq), 128, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, Tk, H, K, nq, st, scale,
      causal, window);
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16.  hd must be 128 or 256, every stride a multiple
// of 16 bytes, the last dim contiguous.  Returns the cudaError_t of the launch.
extern "C" int frontier_flash_attention(const void* q, const void* k, const void* v, void* o,
                                        int dtype, int B, int S, int Tk, int H, int K, int hd,
                                        const int64_t* strides, float scale, int causal,
                                        int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  AttnStrides st = {strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                    strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && hd == 128)
    return launch_fma<float, 128>(q, k, v, o, B, S, Tk, H, K, st, scale, causal, window, s);
  if (dtype == 0 && hd == 256)
    return launch_fma<float, 256>(q, k, v, o, B, S, Tk, H, K, st, scale, causal, window, s);
  if (dtype == 1 && hd == 128)
    return launch_mma<128>(q, k, v, o, B, S, Tk, H, K, st, scale, causal, window, s);
  if (dtype == 1 && hd == 256)
    return launch_mma<256>(q, k, v, o, B, S, Tk, H, K, st, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
