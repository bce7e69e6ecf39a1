// Forward attention softmax(q k^T * scale + mask) v by online softmax, GQA,
// causal (top-left aligned: q_pos >= k_pos) and sliding-window masks.
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention.
//
// One block owns one (batch, head, q-tile) and loops over the KV tiles that
// can hold an unmasked key; the running (m, l, acc) never leave registers.
// Ragged S and T are masked on load from the caller's strided tensors, so no
// padded or transposed copy is made.  The head dim arrives padded to 128 or
// 256 and q arrives pre-scaled so that `scale` is that of the padded dim.
//
//   f32  : flash_fwd_fma    32x32 tiles, FMA only (true f32)
//   bf16 : flash_fwd_wgmma  bound by tensor-core operations.  128 q rows per
//          block as two warpgroups of 64; S = Q K^T and O += P V on wgmma
//          (Q, K and V read from 128-byte-swizzled shared memory, P from
//          registers); K/V tiles of 128 keys (64 at hd 256) stream through a
//          cp.async ring of 3 stages (2 at hd 256), so the next tiles load
//          while this one is multiplied; causal q-tiles are scheduled
//          heaviest first.
#include "wgmma.cuh"

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

// -------------------------------------------------------------- wgmma path --
// Tiles in the 128-byte-swizzled layout of wgmma.cuh (sw128_offset).
template <int HD> struct WgmmaTile {
  static constexpr int BQ = 128, NT = 256;          // two consumer warpgroups of 64 rows
  static constexpr int BK = HD == 128 ? 128 : 64;   // keys per tile: what the registers hold
  static constexpr int STAGES = HD == 128 ? 3 : 2;  // K/V ring depth that fits shared memory
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;       // one K or one V tile
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;  // + alignment slack
};

// rows [r0, r0 + R) of a (rows, HD) bf16 matrix -> swizzled tile; rows at or
// past `valid` are zero-filled.
template <int R, int HD, int NT>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src, int64_t row_stride,
                                          int r0, int valid, int tid) {
  constexpr int C = HD / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < R * C / NT; ++i) {
    const int idx = tid + i * NT, r = idx / C, c = idx % C;
    const bool ok = r0 + r < valid;
    cp_async16(dst + sw128_offset(r, c, R), ok ? src + (int64_t)(r0 + r) * row_stride + c * 8 : src,
               ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(256, 1)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int S, int Tk, int H, int K,
                int nq, AttnStrides st, float scale, int causal, int window) {
  using Cfg = WgmmaTile<HD>;
  constexpr int BQ = Cfg::BQ, BK = Cfg::BK, NT = Cfg::NT, STAGES = Cfg::STAGES;
  constexpr int NO = HD / 128;  // m64n128 products per k-step of P V
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + Cfg::Q_BYTES;  // stage s: K at s * 2 * KV_BYTES, V right after

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int BH = (int)(gridDim.x / nq);
  const int iq = nq - 1 - (int)(blockIdx.x / BH);  // heaviest causal q-tiles first
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kvh = h / (H / K);
  const int q0 = iq * BQ;
  const bf16* qb = q + (int64_t)b * st.q_b + (int64_t)h * st.q_h;
  const bf16* kb = k + (int64_t)b * st.k_b + (int64_t)kvh * st.k_h;
  const bf16* vb = v + (int64_t)b * st.v_b + (int64_t)kvh * st.v_h;
  bf16* ob = o + (int64_t)b * st.o_b + (int64_t)h * st.o_h;
  const float sl2 = scale * 1.4426950408889634f;  // scores in the log2 domain

  int k_lo, k_hi;
  kv_range(q0, BQ, BK, Tk, causal, window, &k_lo, &k_hi);
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  // Q once, then the first STAGES-1 K/V tiles, one commit group each
  load_tile<BQ, HD, NT>(Qs, qb, st.q_s, q0, S, tid);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) {
      uint8_t* kv = KVs + s * 2 * Cfg::KV_BYTES;
      load_tile<BK, HD, NT>(kv, kb, st.k_t, k_lo + s * BK, Tk, tid);
      load_tile<BK, HD, NT>(kv + Cfg::KV_BYTES, vb, st.v_t, k_lo + s * BK, Tk, tid);
    }
    cp_async_commit();
  }

  const int qw0 = q0 + wg * 64;            // this warpgroup's first row
  const int row0 = qw0 + warp * 16 + g;    // this thread's rows: row0 and row0 + 8
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  float oacc[NO][64];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 64; ++i) oacc[n][i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();  // Q and tile t have landed
    fence_proxy_async();
    __syncthreads();               // ... for every thread; tile t-1's stage is free
    {
      const int tn = t + STAGES - 1;
      if (tn < ntiles) {
        uint8_t* kv = KVs + (tn % STAGES) * 2 * Cfg::KV_BYTES;
        load_tile<BK, HD, NT>(kv, kb, st.k_t, k_lo + tn * BK, Tk, tid);
        load_tile<BK, HD, NT>(kv + Cfg::KV_BYTES, vb, st.v_t, k_lo + tn * BK, Tk, tid);
      }
      cp_async_commit();
    }
    const int k0 = k_lo + t * BK;
    // a warpgroup whose 64 rows see no key of this tile skips it
    bool live = qw0 < S;
    if (causal) live = live && k0 <= qw0 + 63;
    if (window) live = live && k0 + BK - 1 > qw0 - window;
    if (!live) continue;
    const uint8_t* Ks = KVs + (t % STAGES) * 2 * Cfg::KV_BYTES;
    const uint8_t* Vs = Ks + Cfg::KV_BYTES;

    // S = Q K^T: 64 rows x BK keys for this warpgroup
    float sacc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t da =
          sw128_desc(Qs + (kk >> 2) * BQ * 128 + wg * 64 * 128 + (kk & 3) * 32, 16, 1024);
      const uint64_t db = sw128_desc(Ks + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16, 1024);
      if constexpr (BK == 128) wgmma_m64n128k16_ss(sacc, da, db, kk > 0);
      else wgmma_m64n64k16_ss(sacc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    // mask only where some (row, key) pair of the tile can be invalid
    const bool full = k0 + BK <= Tk && (!causal || k0 + BK - 1 <= qw0) &&
                      (!window || qw0 + 63 - k0 < window);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float sv = sacc[i] * sl2;
      if (!full) {
        const int qpos = row0 + ((i >> 1) & 1) * 8;
        const int kpos = k0 + (i >> 2) * 8 + 2 * c + (i & 1);
        bool ok = kpos < Tk;
        if (causal) ok = ok && qpos >= kpos;
        if (window) ok = ok && qpos - kpos < window;
        sv = ok ? sv : NEG_INF;
      }
      sacc[i] = sv;
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mc = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
        mc = fmaxf(mc, fmaxf(sacc[nt * 4 + 2 * r], sacc[nt * 4 + 2 * r + 1]));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_new = fmaxf(m_i[r], mc);
      // a row with no valid key yet keeps m == NEG_INF: its p and alpha are 0
      const float alpha = (m_i[r] == NEG_INF) ? 0.f : exp2f(m_i[r] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = (m_new == NEG_INF) ? 0.f : exp2f(sacc[nt * 4 + e] - m_new);
          sacc[nt * 4 + e] = p;
          rowsum += p;
        }
      }
      l_i[r] = l_i[r] * alpha + rowsum;  // partial over this thread's columns
      m_i[r] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          oacc[n][j * 4 + 2 * r] *= alpha;
          oacc[n][j * 4 + 2 * r + 1] *= alpha;
        }
    }

    // O += P V: P from the score accumulators as bf16 A fragments, V from
    // shared memory (MN-major: keys are the product's depth)
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16x2(sacc[8 * kk + 0], sacc[8 * kk + 1]);
      pa[kk][1] = pack_bf16x2(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pa[kk][2] = pack_bf16x2(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pa[kk][3] = pack_bf16x2(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < NO; ++n)
        wgmma_m64n128k16_rs(oacc[n], pa[kk],
                            sw128_desc(Vs + n * 2 * BK * 128 + kk * 16 * 128, BK * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < NO; ++n) fence_regs(oacc[n]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / ((l == 0.f) ? 1.f : l);
    const int qpos = row0 + 8 * r;
    if (qpos < S) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)qpos * st.o_s + n * 128 + j * 8 + 2 * c) =
              __floats2bfloat162_rn(oacc[n][j * 4 + 2 * r] * inv, oacc[n][j * 4 + 2 * r + 1] * inv);
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
static int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int Tk, int H, int K, AttnStrides st, float scale, int causal,
                        int window, cudaStream_t stream) {
  using Cfg = WgmmaTile<HD>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nq = (S + Cfg::BQ - 1) / Cfg::BQ;
  flash_fwd_wgmma<HD><<<(unsigned)((int64_t)B * H * nq), Cfg::NT, Cfg::SMEM, stream>>>(
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
    return launch_wgmma<128>(q, k, v, o, B, S, Tk, H, K, st, scale, causal, window, s);
  if (dtype == 1 && hd == 256)
    return launch_wgmma<256>(q, k, v, o, B, S, Tk, H, K, st, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
