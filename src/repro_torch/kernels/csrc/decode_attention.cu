// One query token per sequence against a KV cache (GQA), split over the keys.
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention.
//
// The work is bound by the bytes of the cache: each key and value is used for
// 4 G operations, far below what the tensor cores need, so the levers are
// filling the card and keeping loads in flight.
//
//   decode_split    grid (split, batch, kv-head).  A block owns `span` keys of
//                   one row and the G query heads of its group, so each KV
//                   byte is read once per group.  A split at or past
//                   lengths[b] writes (m, l) = (NEG_INF, 0) and returns.  K/V
//                   tiles of 16 KB stream through a cp.async double buffer in
//                   their own dtype.  Each of the 4 warps owns a quarter of
//                   every tile and keeps its own online-softmax state: scores
//                   by 8 lanes per key with shuffle reductions, P V by lanes
//                   over the head dim; the warps merge once at the end.  With
//                   one split the block writes the output itself; otherwise it
//                   writes f32 partials (o, m, l).
//   decode_combine  merges the splits in a fixed order (no atomics, so a
//                   result is the same from run to run).
//
// Both dtypes take the same kernels (f32 FMA arithmetic), so the f32 gate
// also holds the split and combine arithmetic.  Scores live in the log2
// domain (q is scaled by scale * log2 e), m included.
#include "common.cuh"

struct DecodeStrides {
  int64_t q_b, q_h;
  int64_t k_b, k_t, k_h;
  int64_t v_b, v_t, v_h;
  int64_t o_b, o_h;
};

template <typename T, int HD> struct DecodeTile {
  static constexpr int NT = 128, NW = NT / 32;
  static constexpr int BK = 16384 / (HD * (int)sizeof(T));  // keys in a 16 KB tile
  static constexpr int KW = BK / NW;                         // keys per warp per tile
  static constexpr int ROW = HD * (int)sizeof(T);            // bytes of one key row
  static constexpr int TILE = BK * ROW;
  static constexpr int VPL = HD / 32;                        // head-dim columns per lane
  static size_t smem(int G) {
    return 4 * (size_t)TILE + sizeof(float) * ((size_t)G * HD + (size_t)NW * G * KW);
  }
};

// N consecutive values from shared memory, widened to f32 (N = 4 or 8).
template <typename T, int N> __device__ __forceinline__ void ld_f32(const T* p, float* out) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = f.x; out[4 * i + 1] = f.y; out[4 * i + 2] = f.z; out[4 * i + 3] = f.w;
    }
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  } else {
    Vec16<bf16>::load(p, out);
  }
}

// rows [r0, r0 + BK) of K or V -> a dense tile; rows at or past `end` zero-filled
template <typename T, int HD>
__device__ __forceinline__ void load_kv(uint8_t* dst, const T* src, int64_t row_stride, int r0,
                                        int end, int tid) {
  using D = DecodeTile<T, HD>;
  constexpr int C = D::ROW / 16;
#pragma unroll
  for (int i = 0; i < D::BK * C / D::NT; ++i) {
    const int idx = tid + i * D::NT, r = idx / C, c = idx % C;
    const bool ok = r0 + r < end;
    cp_async16(dst + r * D::ROW + c * 16,
               ok ? reinterpret_cast<const uint8_t*>(src + (int64_t)(r0 + r) * row_stride) + c * 16
                  : reinterpret_cast<const uint8_t*>(src),
               ok);
  }
}

// GM: a compile-time bound on G (query heads per KV head), G <= GM <= 32.
template <typename T, int HD, int GM>
__global__ void __launch_bounds__(128)
decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, float* __restrict__ part_o, float* __restrict__ part_ml,
             const int* __restrict__ lengths, int B, int Tk, int K, int G, int span,
             int nsplit, DecodeStrides st, float scale) {
  using D = DecodeTile<T, HD>;
  constexpr int NT = D::NT, NW = D::NW, BK = D::BK, KW = D::KW, VPL = D::VPL;
  constexpr int C = D::ROW / 16;        // 16-byte chunks of a key row
  constexpr int EPC = 16 / sizeof(T);   // elements in a chunk
  constexpr int KPL = HD / 8;           // key elements per lane in the score step
  extern __shared__ __align__(16) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem + 4 * D::TILE);  // G x HD, log2-scaled
  float* Ss = Qs + G * HD;                                   // NW x G x KW scores / p

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x % K;
  const int b = (blockIdx.x / K) % B;
  const int split = blockIdx.x / (K * B);
  const int H = K * G;
  const int len = min(lengths[b], Tk);
  const int start = split * span, end = min(start + span, len);
  const int64_t prow = ((int64_t)split * B + b) * H + (int64_t)kvh * G;  // partial row of g = 0
  T* ob = o + (int64_t)b * st.o_b + (int64_t)(kvh * G) * st.o_h;

  if (start >= end) {  // no valid key of this row in this split
    if (nsplit == 1) {
      for (int idx = tid; idx < G * HD; idx += NT)
        ob[(int64_t)(idx / HD) * st.o_h + idx % HD] = from_f32<T>(0.f);
    } else {
      for (int g = tid; g < G; g += NT) {
        part_ml[2 * (prow + g)] = NEG_INF;
        part_ml[2 * (prow + g) + 1] = 0.f;
      }
    }
    return;
  }

  const T* qb = q + (int64_t)b * st.q_b + (int64_t)(kvh * G) * st.q_h;
  const T* kb = k + (int64_t)b * st.k_b + (int64_t)kvh * st.k_h;
  const T* vb = v + (int64_t)b * st.v_b + (int64_t)kvh * st.v_h;
  const int ntiles = (end - start + BK - 1) / BK;

  load_kv<T, HD>(smem, kb, st.k_t, start, end, tid);
  load_kv<T, HD>(smem + D::TILE, vb, st.v_t, start, end, tid);
  cp_async_commit();

  const float sl2 = scale * 1.4426950408889634f;
  for (int idx = tid; idx < G * HD / EPC; idx += NT) {
    const int g = idx / (HD / EPC), c = (idx % (HD / EPC)) * EPC;
    float tmp[EPC];
    Vec16<T>::load(qb + (int64_t)g * st.q_h + c, tmp);
#pragma unroll
    for (int i = 0; i < EPC; ++i) Qs[g * HD + c + i] = tmp[i] * sl2;
  }

  float* Sw = Ss + warp * G * KW;
  float m_lane = NEG_INF, l_lane = 0.f;  // lane g < G holds row g's running max and sum
  float acc[GM][VPL];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc[g][j] = 0.f;

  const int sub = lane >> 3, j8 = lane & 7;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      uint8_t* nxt = smem + ((t + 1) & 1) * 2 * D::TILE;
      load_kv<T, HD>(nxt, kb, st.k_t, start + (t + 1) * BK, end, tid);
      load_kv<T, HD>(nxt + D::TILE, vb, st.v_t, start + (t + 1) * BK, end, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, Qs) visible to every warp
    const uint8_t* Kt = smem + (t & 1) * 2 * D::TILE;
    const uint8_t* Vt = Kt + D::TILE;
    const int k0 = start + t * BK + warp * KW;  // this warp's first key

    // scores: 8 lanes per key, lane j8 takes 16-byte chunks j8, j8 + 8, ...;
    // the G rows' dot products and reductions are independent, so they are
    // unrolled side by side
#pragma unroll
    for (int p = 0; p < KW / 4; ++p) {
      const int key = p * 4 + sub;
      const T* kr = reinterpret_cast<const T*>(Kt + (warp * KW + key) * D::ROW);
      float kf[KPL];
#pragma unroll
      for (int i = 0; i < C / 8; ++i) Vec16<T>::load(kr + (j8 + 8 * i) * EPC, kf + i * EPC);
      float s[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        s[g] = 0.f;
        if (g < G) {
          const float* qr = Qs + g * HD;
          float s2 = 0.f;
#pragma unroll
          for (int i = 0; i < C / 8; ++i)
#pragma unroll
            for (int e = 0; e < EPC; e += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qr + (j8 + 8 * i) * EPC + e);
              s[g] = fmaf(qq.x, kf[i * EPC + e], s[g]);
              s2 = fmaf(qq.y, kf[i * EPC + e + 1], s2);
              s[g] = fmaf(qq.z, kf[i * EPC + e + 2], s[g]);
              s2 = fmaf(qq.w, kf[i * EPC + e + 3], s2);
            }
          s[g] += s2;
        }
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      if (j8 == 0) {
        const bool ok = k0 + key < end;
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) Sw[g * KW + key] = ok ? s[g] : NEG_INF;
      }
    }
    __syncwarp();

    // online softmax over this warp's KW keys, one key per lane
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float s = lane < KW ? Sw[g * KW + lane] : NEG_INF;
        const float m_old = __shfl_sync(0xffffffffu, m_lane, g);
        const float m_new = fmaxf(m_old, warp_max(s));
        // a row with no valid key yet keeps m == NEG_INF: its p and alpha are 0
        const float p = (m_new == NEG_INF) ? 0.f : exp2f(s - m_new);
        const float alpha = (m_old == NEG_INF) ? 0.f : exp2f(m_old - m_new);
        const float psum = warp_sum(p);
        if (lane == g) {
          m_lane = m_new;
          l_lane = l_lane * alpha + psum;
        }
        if (lane < KW) Sw[g * KW + lane] = p;
#pragma unroll
        for (int j = 0; j < VPL; ++j) acc[g][j] *= alpha;
      }
    }
    __syncwarp();

    // acc += P V over this warp's keys; lane owns columns lane*VPL ...
#pragma unroll 4
    for (int kk = 0; kk < KW; ++kk) {
      float vv[VPL];
      ld_f32<T, VPL>(reinterpret_cast<const T*>(Vt + (warp * KW + kk) * D::ROW) + lane * VPL, vv);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float p = Sw[g * KW + kk];
#pragma unroll
          for (int j = 0; j < VPL; ++j) acc[g][j] = fmaf(p, vv[j], acc[g][j]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // merge the warps: their (m, l) into Ss, their acc into the idle K/V stages
  float* Mw = Ss;
  float* Lw = Ss + NW * G;
  float* Aw = reinterpret_cast<float*>(smem);  // NW x G x HD <= 4 tiles
  if (lane < G) {
    Mw[warp * G + lane] = m_lane;
    Lw[warp * G + lane] = l_lane;
  }
#pragma unroll
  for (int g = 0; g < GM; ++g)
    if (g < G)
#pragma unroll
      for (int j = 0; j < VPL; ++j) Aw[(warp * G + g) * HD + lane * VPL + j] = acc[g][j];
  __syncthreads();

  for (int idx = tid; idx < G * HD; idx += NT) {
    const int g = idx / HD, d = idx % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Mw[w * G + g]);
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = Mw[w * G + g];
      const float wt = (mw == NEG_INF) ? 0.f : exp2f(mw - M);
      L = fmaf(wt, Lw[w * G + g], L);
      a = fmaf(wt, Aw[(w * G + g) * HD + d], a);
    }
    if (nsplit == 1) {
      ob[(int64_t)g * st.o_h + d] = from_f32<T>(L == 0.f ? 0.f : a / L);
    } else {
      part_o[(prow + g) * HD + d] = a;
      if (d == 0) {
        part_ml[2 * (prow + g)] = M;
        part_ml[2 * (prow + g) + 1] = L;
      }
    }
  }
}

// out[b, h] = sum_s w_s o_s / sum_s w_s l_s with w_s = 2^(m_s - max m), in split order.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
               T* __restrict__ o, int B, int H, int nsplit, DecodeStrides st) {
  const int b = blockIdx.x / H, h = blockIdx.x % H, d = threadIdx.x;
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s)
    M = fmaxf(M, part_ml[2 * (((int64_t)s * B + b) * H + h)]);
  float L = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const int64_t row = ((int64_t)s * B + b) * H + h;
    const float m = part_ml[2 * row];
    if (m == NEG_INF) continue;  // an empty split: its partial o was never written
    const float w = exp2f(m - M);
    L = fmaf(w, part_ml[2 * row + 1], L);
    a = fmaf(w, part_o[row * HD + d], a);
  }
  o[(int64_t)b * st.o_b + (int64_t)h * st.o_h + d] = from_f32<T>(L == 0.f ? 0.f : a / L);
}

template <typename T, int HD, int GM>
static int launch(const void* q, const void* k, const void* v, void* o, const int* lengths,
                  float* part_o, float* part_ml, int B, int Tk, int K, int G, int span,
                  int nsplit, DecodeStrides st, float scale, cudaStream_t stream) {
  const size_t smem = DecodeTile<T, HD>::smem(G);
  cudaError_t err = cudaFuncSetAttribute(decode_split<T, HD, GM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_split<T, HD, GM><<<(unsigned)((int64_t)nsplit * B * K), DecodeTile<T, HD>::NT, smem,
                            stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, part_o,
                                      part_ml, lengths, B, Tk, K, G, span, nsplit, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  decode_combine<T, HD><<<(unsigned)((int64_t)B * K * G), HD, 0, stream>>>(
      part_o, part_ml, (T*)o, B, K * G, nsplit, st);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
static int dispatch_g(const void* q, const void* k, const void* v, void* o, const int* len,
                      float* po, float* pml, int B, int Tk, int K, int G, int span, int nsplit,
                      DecodeStrides st, float scale, cudaStream_t s) {
#define FRONTIER_DECODE_G(GM)                                                                 \
  if (G <= GM)                                                                                \
    return launch<T, HD, GM>(q, k, v, o, len, po, pml, B, Tk, K, G, span, nsplit, st, scale, \
                             s);
  FRONTIER_DECODE_G(1)
  FRONTIER_DECODE_G(2)
  FRONTIER_DECODE_G(4)
  FRONTIER_DECODE_G(8)
  FRONTIER_DECODE_G(16)
  if constexpr (HD == 128) {
    FRONTIER_DECODE_G(32)
  }
#undef FRONTIER_DECODE_G
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = f32, 1 = bf16.  hd must be 128 or 256, every stride a multiple
// of 16 bytes, the last dim contiguous, lengths int32 on the device.
// G = H / K query heads per group, at most 16 * 256 / hd.  Split s owns keys
// [s * span, (s + 1) * span); with nsplit > 1, part_o (nsplit, B, H, hd) and
// part_ml (nsplit, B, H, 2) are f32 scratch, otherwise they may be null.
extern "C" int frontier_decode_attention(const void* q, const void* k, const void* v, void* o,
                                         const void* lengths, void* part_o, void* part_ml,
                                         int dtype, int B, int Tk, int H, int K, int hd,
                                         int nsplit, int span, const int64_t* strides,
                                         float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K || H / K > 16 * 256 / hd || nsplit < 1 || span < 1 ||
      (nsplit > 1 && (!part_o || !part_ml)))
    return (int)cudaErrorInvalidValue;
  DecodeStrides st = {strides[0], strides[1], strides[2], strides[3], strides[4],
                      strides[5], strides[6], strides[7], strides[8], strides[9]};
  cudaStream_t s = (cudaStream_t)stream;
  const int G = H / K;
  const int* len = (const int*)lengths;
  float* po = (float*)part_o;
  float* pml = (float*)part_ml;
  if (hd == 128 && dtype == 0)
    return dispatch_g<float, 128>(q, k, v, o, len, po, pml, B, Tk, K, G, span, nsplit, st, scale, s);
  if (hd == 128 && dtype == 1)
    return dispatch_g<bf16, 128>(q, k, v, o, len, po, pml, B, Tk, K, G, span, nsplit, st, scale, s);
  if (hd == 256 && dtype == 0)
    return dispatch_g<float, 256>(q, k, v, o, len, po, pml, B, Tk, K, G, span, nsplit, st, scale, s);
  if (hd == 256 && dtype == 1)
    return dispatch_g<bf16, 256>(q, k, v, o, len, po, pml, B, Tk, K, G, span, nsplit, st, scale, s);
  return (int)cudaErrorInvalidValue;
}
