// One query token per sequence against a KV cache (GQA).
//
// One block owns one (batch, kv-head): the G = H/K query heads of the group
// share every KV tile, which is read from device memory once.  The block
// reads lengths[b] itself and loops over 64-key tiles up to that length, so
// keys past the length cost nothing; the online-softmax state (m, l) lives
// in shared memory, the output accumulators in registers.
//
// The work is bound by the bytes of the cache, so both dtypes take the same
// FMA path: tiles are widened to f32 on the way into shared memory.
#include "common.cuh"

struct DecodeStrides {
  int64_t q_b, q_h;
  int64_t k_b, k_t, k_h;
  int64_t v_b, v_t, v_h;
  int64_t o_b, o_h;
};

// NJ: output accumulators per thread.  Thread t owns head-dim column t % HD
// of query rows t / HD, t / HD + 256 / HD, ... (NJ of them, those < G).
template <typename T, int HD, int NJ>
__global__ void __launch_bounds__(256)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, const int* __restrict__ lengths, int Tk, int K, int G,
           DecodeStrides st, float scale) {
  constexpr int BK = 64, LD = HD + 4, NT = 256;
  constexpr int VEC = Vec16<T>::N;
  constexpr int GSTEP = NT / HD;
  extern __shared__ __align__(16) float smem_f[];
  float* Ks = smem_f;             // BK x LD
  float* Vs = Ks + BK * LD;       // BK x HD
  float* Qs = Vs + BK * HD;       // G x HD
  float* Ss = Qs + G * HD;        // G x BK
  float* ms = Ss + G * BK;        // G
  float* ls = ms + G;             // G
  float* alphas = ls + G;         // G

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / K, kvh = blockIdx.x % K;
  const int len = min(lengths[b], Tk);
  const T* qb = q + (int64_t)b * st.q_b + (int64_t)(kvh * G) * st.q_h;
  const T* kb = k + (int64_t)b * st.k_b + (int64_t)kvh * st.k_h;
  const T* vb = v + (int64_t)b * st.v_b + (int64_t)kvh * st.v_h;
  T* ob = o + (int64_t)b * st.o_b + (int64_t)(kvh * G) * st.o_h;

  for (int idx = tid; idx < G * HD / VEC; idx += NT) {
    const int g = idx / (HD / VEC), c = (idx % (HD / VEC)) * VEC;
    float tmp[VEC];
    Vec16<T>::load(qb + (int64_t)g * st.q_h + c, tmp);
#pragma unroll
    for (int i = 0; i < VEC; ++i) Qs[g * HD + c + i] = tmp[i];
  }
  for (int g = tid; g < G; g += NT) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }

  const int d = tid % HD, g0 = tid / HD;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < len; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * HD / VEC; idx += NT) {
      const int r = idx / (HD / VEC), c = (idx % (HD / VEC)) * VEC;
      float tk[VEC], tv[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) { tk[i] = 0.f; tv[i] = 0.f; }
      if (k0 + r < len) {
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

    // scores: one (query row, key) pair per thread and pass
    for (int idx = tid; idx < G * BK; idx += NT) {
      const int g = idx / BK, pos = idx % BK;
      const float4* qr = reinterpret_cast<const float4*>(Qs + g * HD);
      const float4* kr = reinterpret_cast<const float4*>(Ks + pos * LD);
      float s = 0.f;
#pragma unroll 8
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 qq = qr[d4], kk = kr[d4];
        s = fmaf(qq.x, kk.x, s);
        s = fmaf(qq.y, kk.y, s);
        s = fmaf(qq.z, kk.z, s);
        s = fmaf(qq.w, kk.w, s);
      }
      Ss[idx] = (k0 + pos < len) ? s * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w + 8, ...
    for (int g = warp; g < G; g += NT / 32) {
      const float s0 = Ss[g * BK + lane], s1 = Ss[g * BK + lane + 32];
      const float m_prev = ms[g], l_prev = ls[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = (m_new == NEG_INF) ? 0.f : expf(s0 - m_new);
      const float p1 = (m_new == NEG_INF) ? 0.f : expf(s1 - m_new);
      const float alpha = (m_prev == NEG_INF) ? 0.f : expf(m_prev - m_new);
      const float psum = warp_sum(p0 + p1);
      Ss[g * BK + lane] = p0;
      Ss[g * BK + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = l_prev * alpha + psum;
        alphas[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int g = g0 + j * GSTEP;
      if (g < G) acc[j] *= alphas[g];
    }
    for (int pos = 0; pos < BK; ++pos) {
      const float vv = Vs[pos * HD + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int g = g0 + j * GSTEP;
        if (g < G) acc[j] = fmaf(Ss[g * BK + pos], vv, acc[j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int g = g0 + j * GSTEP;
    if (g < G) {
      const float l = ls[g];
      const float denom = (l == 0.f) ? 1.f : l;
      ob[(int64_t)g * st.o_h + d] = from_f32<T>(acc[j] / denom);
    }
  }
}

template <typename T, int HD, int NJ>
static int launch(const void* q, const void* k, const void* v, void* o, const int* lengths,
                  int B, int Tk, int K, int G, DecodeStrides st, float scale,
                  cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)64 * (HD + 4) + 64 * HD + (size_t)G * HD + (size_t)G * 64 + 3 * G);
  cudaError_t err = cudaFuncSetAttribute(decode_fwd<T, HD, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_fwd<T, HD, NJ><<<(unsigned)((int64_t)B * K), 256, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lengths, Tk, K, G, st, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
static int dispatch_nj(int nj, const void* q, const void* k, const void* v, void* o,
                       const int* lengths, int B, int Tk, int K, int G, DecodeStrides st,
                       float scale, cudaStream_t s) {
  if (nj <= 1) return launch<T, HD, 1>(q, k, v, o, lengths, B, Tk, K, G, st, scale, s);
  if (nj <= 2) return launch<T, HD, 2>(q, k, v, o, lengths, B, Tk, K, G, st, scale, s);
  if (nj <= 4) return launch<T, HD, 4>(q, k, v, o, lengths, B, Tk, K, G, st, scale, s);
  if (nj <= 8) return launch<T, HD, 8>(q, k, v, o, lengths, B, Tk, K, G, st, scale, s);
  if (nj <= 16) return launch<T, HD, 16>(q, k, v, o, lengths, B, Tk, K, G, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = f32, 1 = bf16.  hd must be 128 or 256, every stride a multiple
// of 16 bytes, the last dim contiguous, lengths int32 on the device.
// G = H / K query heads per group, at most 16 * 256 / hd.
extern "C" int frontier_decode_attention(const void* q, const void* k, const void* v, void* o,
                                         const void* lengths, int dtype, int B, int Tk, int H,
                                         int K, int hd, const int64_t* strides, float scale,
                                         void* stream) {
  if (B <= 0 || H <= 0) return 0;
  DecodeStrides st = {strides[0], strides[1], strides[2], strides[3], strides[4],
                      strides[5], strides[6], strides[7], strides[8], strides[9]};
  cudaStream_t s = (cudaStream_t)stream;
  const int G = H / K;
  const int* len = (const int*)lengths;
  if (hd == 128) {
    const int nj = (G + 1) / 2;
    if (dtype == 0)
      return dispatch_nj<float, 128>(nj, q, k, v, o, len, B, Tk, K, G, st, scale, s);
    if (dtype == 1)
      return dispatch_nj<bf16, 128>(nj, q, k, v, o, len, B, Tk, K, G, st, scale, s);
  } else if (hd == 256) {
    const int nj = G;
    if (dtype == 0)
      return dispatch_nj<float, 256>(nj, q, k, v, o, len, B, Tk, K, G, st, scale, s);
    if (dtype == 1)
      return dispatch_nj<bf16, 256>(nj, q, k, v, o, len, B, Tk, K, G, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
