// RWKV6 recurrence in chunks of C (chunked-parallel WKV6).
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t ;  y_t = r_t (S_{t-1} + u k_t^T v_t)
//
// Per chunk, with clw the in-chunk cumulative sum of log w:
//   r_dec = r * exp(clw_{t-1}),  k_dec = k * exp(min(-clw, 60))
//   y     = r_dec @ S + strict_lower(r_dec @ k_dec^T) @ v + (r.u.k) v
//   S     = diag(exp(clw_last)) S + (k * exp(clw_last) * exp(min(-clw, 60)))^T @ v
//
// One block per (column tile of S, head, batch row) loops over the chunks with
// its hs x JT slice of S resident in shared memory: column j of S and of y
// depends only on column j of v, so the tiles are exact and independent, and
// B*H*hs/JT blocks keep the card's SMs busy at one request.  The per-chunk
// terms on the channel side (decays, r_dec, k_dec, the (C, C) intra-chunk
// matrix and the bonus) are recomputed by every column tile of a head.
// r/k/v/w are read from the caller's (B,T,H,hs) strides; y is written
// contiguous.  All arithmetic is f32 FMA (no TF32); bf16 inputs are widened on
// load and the output is rounded once.
#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int JT = 16;   // columns of S (and of v, y) one block owns

struct WkvArgs {
  const void *r, *k, *v, *w;
  const float* u;        // (H, hs) f32
  const float* state0;   // (B, H, hs, hs) f32, or null for zeros
  void* y;               // (B, T, H, hs) contiguous
  float* state_out;      // (B, H, hs, hs) f32, or null
  int64_t st[4][3];      // (b, t, h) element strides of r, k, v, w
  int T, H, hs, C;
};

template <typename T>
__device__ __forceinline__ float ld(const T* base, int64_t off) {
  return to_f32(base[off]);
}

template <typename T, typename TW, typename TO>
__global__ void __launch_bounds__(NT) wkv_chunk_kernel(WkvArgs a) {
  extern __shared__ float smem[];
  const int hs = a.hs, C = a.C;
  const int j0 = blockIdx.x * JT, h = blockIdx.y, b = blockIdx.z;
  const int jn = min(JT, hs - j0);
  const int tid = threadIdx.x;

  float* rs = smem;             // C*hs: r, then r_dec
  float* ks = rs + C * hs;      // C*hs: k, then k_dec
  float* kc = ks + C * hs;      // C*hs: k_carry
  float* ls = kc + C * hs;      // C*hs: log w, then its in-chunk cumsum
  float* S = ls + C * hs;       // hs*JT: state columns j0 .. j0+jn
  float* vs = S + hs * JT;      // C*JT: v columns j0 .. j0+jn
  float* att = vs + C * JT;     // C*C: intra-chunk matrix, bonus on the diagonal
  float* bs = att + C * C;      // C: bonus r.u.k per row
  float* cl = bs + C;           // hs: clw of the chunk's last row
  float* us = cl + hs;          // hs: u for this head

  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const TW* w = static_cast<const TW*>(a.w);
  const int64_t rb = b * a.st[0][0] + h * a.st[0][2], rt = a.st[0][1];
  const int64_t kb = b * a.st[1][0] + h * a.st[1][2], kt = a.st[1][1];
  const int64_t vb = b * a.st[2][0] + h * a.st[2][2], vt = a.st[2][1];
  const int64_t wb = b * a.st[3][0] + h * a.st[3][2], wt = a.st[3][1];
  const int64_t sbase = ((int64_t)b * a.H + h) * hs * hs;

  for (int i = tid; i < hs; i += NT) us[i] = a.u[(int64_t)h * hs + i];
  for (int idx = tid; idx < hs * JT; idx += NT) {
    const int i = idx / JT, jj = idx % JT;
    S[idx] = (a.state0 != nullptr && jj < jn) ? a.state0[sbase + (int64_t)i * hs + j0 + jj] : 0.f;
  }

  for (int c0 = 0; c0 < a.T; c0 += C) {
    __syncthreads();  // the previous chunk is done with every buffer
    // 1. load the chunk: r, k, log(max(w, 1e-30)) and v's columns
    for (int idx = tid; idx < C * hs; idx += NT) {
      const int t = idx / hs, i = idx % hs;
      const int64_t tt = c0 + t;
      rs[idx] = ld(r, rb + tt * rt + i);
      ks[idx] = ld(k, kb + tt * kt + i);
      ls[idx] = logf(fmaxf(ld(w, wb + tt * wt + i), 1e-30f));
    }
    for (int idx = tid; idx < C * JT; idx += NT) {
      const int t = idx / JT, jj = idx % JT;
      vs[idx] = jj < jn ? ld(v, vb + (int64_t)(c0 + t) * vt + j0 + jj) : 0.f;
    }
    __syncthreads();

    // 2. bonus per row (one warp a row) and the cumulative log-decay per
    //    channel (one thread a channel, sequential in t as the reference's
    //    cumsum)
    {
      const int lane = tid & 31, warp = tid >> 5;
      for (int t = warp; t < C; t += NT / 32) {
        float sum = 0.f;
        for (int i = lane; i < hs; i += 32) sum += rs[t * hs + i] * us[i] * ks[t * hs + i];
        sum = warp_sum(sum);
        if (lane == 0) bs[t] = sum;
      }
      for (int i = tid; i < hs; i += NT) {
        float c = 0.f;
        for (int t = 0; t < C; ++t) {
          c += ls[t * hs + i];
          ls[t * hs + i] = c;
        }
        cl[i] = c;
      }
    }
    __syncthreads();

    // 3. decayed r and k, and the k that carries into the next chunk's state
    for (int idx = tid; idx < C * hs; idx += NT) {
      const int t = idx / hs, i = idx % hs;
      const float clw = ls[idx];
      const float prev = t > 0 ? ls[idx - hs] : 0.f;  // clw_{t-1}
      const float e = expf(fminf(-clw, 60.f));
      const float kk = ks[idx];
      rs[idx] = rs[idx] * expf(prev);
      ks[idx] = kk * e;
      kc[idx] = kk * (expf(cl[i]) * e);
    }
    __syncthreads();

    // 4. intra-chunk matrix: strictly lower r_dec . k_dec, bonus on the diagonal
    for (int idx = tid; idx < C * C; idx += NT) {
      const int t = idx / C, s = idx % C;
      float acc = 0.f;
      if (s < t) {
        for (int i = 0; i < hs; ++i) acc = fmaf(rs[t * hs + i], ks[s * hs + i], acc);
      } else if (s == t) {
        acc = bs[t];
      }
      att[idx] = acc;
    }
    __syncthreads();

    // 5. y = r_dec @ S + att @ v  (inter-chunk, then intra-chunk, then bonus)
    TO* y = static_cast<TO*>(a.y);
    for (int idx = tid; idx < C * JT; idx += NT) {
      const int t = idx / JT, jj = idx % JT;
      if (jj >= jn) continue;
      float acc = 0.f;
      for (int i = 0; i < hs; ++i) acc = fmaf(rs[t * hs + i], S[i * JT + jj], acc);
      float intra = 0.f;
      for (int s = 0; s < t; ++s) intra = fmaf(att[t * C + s], vs[s * JT + jj], intra);
      acc += intra;
      acc = fmaf(att[t * C + t], vs[t * JT + jj], acc);
      const int64_t out = (((int64_t)b * a.T + c0 + t) * a.H + h) * hs + j0 + jj;
      y[out] = from_f32<TO>(acc);
    }
    __syncthreads();

    // 6. carry the state to the chunk's end
    for (int idx = tid; idx < hs * JT; idx += NT) {
      const int i = idx / JT, jj = idx % JT;
      float acc = 0.f;
      for (int s = 0; s < C; ++s) acc = fmaf(kc[s * hs + i], vs[s * JT + jj], acc);
      S[idx] = fmaf(S[idx], expf(cl[i]), acc);
    }
  }

  if (a.state_out != nullptr) {
    __syncthreads();
    for (int idx = tid; idx < hs * JT; idx += NT) {
      const int i = idx / JT, jj = idx % JT;
      if (jj < jn) a.state_out[sbase + (int64_t)i * hs + j0 + jj] = S[idx];
    }
  }
}

size_t smem_bytes(int hs, int C) {
  return sizeof(float) * (4 * (size_t)C * hs + (size_t)hs * JT + (size_t)C * JT +
                          (size_t)C * C + C + 2 * (size_t)hs);
}

template <typename T, typename TW, typename TO>
int launch(const WkvArgs& a, int B, cudaStream_t stream) {
  auto kern = wkv_chunk_kernel<T, TW, TO>;
  const size_t smem = smem_bytes(a.hs, a.C);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.hs + JT - 1) / JT, a.H, B);
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename TW>
int launch_out(int out_dtype, const WkvArgs& a, int B, cudaStream_t s) {
  if (out_dtype == 0) return launch<T, TW, float>(a, B, s);
  if (out_dtype == 1) return launch<T, TW, bf16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_w(int w_dtype, int out_dtype, const WkvArgs& a, int B, cudaStream_t s) {
  if (w_dtype == 0) return launch_out<T, float>(out_dtype, a, B, s);
  if (w_dtype == 1) return launch_out<T, bf16>(out_dtype, a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = f32, 1 = bf16 (r/k/v share one; w and y may differ).
// r/k/v/w (B,T,H,hs) with a unit last stride and the (b, t, h) element strides
// of each in `strides` (12 values, r k v w in turn); u (H,hs) f32 contiguous;
// state0 and state_out (B,H,hs,hs) f32 contiguous or null; y (B,T,H,hs)
// contiguous.  T % C == 0.  Returns the cudaError_t.
extern "C" int frontier_wkv_chunked(const void* r, const void* k, const void* v, const void* w,
                                    const void* u, const void* state0, void* y, void* state_out,
                                    int dtype, int w_dtype, int out_dtype, int B, int T, int H,
                                    int hs, int C, const int64_t* strides, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || hs <= 0) return 0;
  if (C <= 0 || T % C != 0 || smem_bytes(hs, C) > 227 * 1024) return (int)cudaErrorInvalidValue;
  WkvArgs a;
  a.r = r; a.k = k; a.v = v; a.w = w;
  a.u = (const float*)u;
  a.state0 = (const float*)state0;
  a.y = y;
  a.state_out = (float*)state_out;
  for (int x = 0; x < 4; ++x)
    for (int d = 0; d < 3; ++d) a.st[x][d] = strides[3 * x + d];
  a.T = T; a.H = H; a.hs = hs; a.C = C;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_w<float>(w_dtype, out_dtype, a, B, s);
  if (dtype == 1) return launch_w<bf16>(w_dtype, out_dtype, a, B, s);
  return (int)cudaErrorInvalidValue;
}
