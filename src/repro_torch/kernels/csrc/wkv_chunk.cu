// RWKV6 recurrence in chunks of C (chunked-parallel WKV6).  Replaces the TPU
// kernel repro/kernels/wkv_chunk.py::wkv_chunked (body _wkv_kernel).
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t ;  y_t = r_t (S_{t-1} + u k_t^T v_t)
//
// Per chunk, with clw the in-chunk cumulative sum of log w:
//   r_dec = r * exp(clw_{t-1}),  k_dec = k * exp(min(-clw, 60))
//   y     = r_dec @ S + strict_lower(r_dec @ k_dec^T) @ v + (r.u.k) v
//   S     = diag(exp(clw_last)) S + (k * exp(clw_last) * exp(min(-clw, 60)))^T @ v
//
// What bounds it on an H100 is the chain of chunks, not bytes or operations:
// at one 2048-token request of rwkv6-1.6b (32 heads of 64, C = 16) the card
// could do the work in 0.018 ms, but the state passes through 128 chunks in
// order.  Only the carry S <- diag(a) S + k_carry^T v is on that chain.  The
// chunk's decays, r_dec, k_carry, the (C, C) intra-chunk matrix, the bonus and
// y_intra = att @ v depend on its inputs alone, and y = y_intra + r_dec @ S
// needs only the state entering it.
//
// So a block owns 16 state columns of one (head, batch row) (column j of S and
// of y depends only on column j of v: the tiles are exact and independent,
// and one request still fills 128 SMs), in three roles:
//   - 8 prep warps compute a chunk's state-free terms into a ring slot of
//     shared memory, up to two chunks ahead.  The raw inputs of the next
//     chunks stream in by cp.async (which, unlike loads into registers, a
//     block barrier does not wait for).  The cumulative decays are running
//     products of w, not exponentials of sums of log w: the same function,
//     with no transcendental on the way.  The intra-chunk matrix is built in
//     4x4 blocks with the depth split over eight lanes, so each operand read
//     from shared memory feeds four products.
//   - 4 carry warps hold their 64 x 16 slice of S in registers (each lane 8
//     rows of one column), hand a copy of the state entering each chunk to
//     the y warps, and carry it to the chunk's end: the whole serial chain.
//   - 4 y warps form y = y_intra + r_dec @ S from that copy, beside the chain.
// mbarriers hand the slots and the state copies between the roles; no role
// waits on another's block barrier.  The prep work is repeated by the four
// column blocks of a head, beside the chain, not in it.  r/k/v/w are read
// from the caller's (B,T,H,hs) strides (by plain loads where they are not
// 16-byte aligned); y is written contiguous.  All arithmetic is f32 FMA (no
// TF32) and IEEE division; bf16 inputs are widened on load and the output is
// rounded once.
#include "common.cuh"

namespace {

constexpr int NPREP = 256;  // prep threads (warps 0-7)
constexpr int NCARRY = 128; // carry threads (warps 8-11)
constexpr int NY = 128;     // y threads (warps 12-15)
constexpr int NT = NPREP + NCARRY + NY;
constexpr int JT = 16;      // columns of S (and of v, y) one block owns
constexpr int IG = 8;       // row groups of a column: 8 lanes of a warp
constexpr int KS = 8;       // lanes that split the depth of an intra-chunk dot
constexpr int NS = 2;       // copies of the state between the carry and y warps
constexpr int NBAR = 8;     // full, empty, state-full, state-empty: two of each
constexpr float EXP60 = 1.14200738981568e26f;  // exp(60), the Pallas kernel's clamp
constexpr int SMEM_MAX = 232448;

struct WkvArgs {
  const void *r, *k, *v, *w;
  const float* u;        // (H, hs) f32
  const float* state0;   // (B, H, hs, hs) f32, or null for zeros
  void* y;               // (B, T, H, hs) contiguous
  float* state_out;      // (B, H, hs, hs) f32, or null
  int64_t st[4][3];      // (b, t, h) element strides of r, k, v, w
  int T, H, hs, C;
  bool staged;           // inputs 16-byte aligned: cp.async stages; else plain loads
};

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) & ~15; }

// Shared memory, after the barriers, every region 16-byte aligned.  Rows of
// C x HM matrices are LD = HM + 4 floats apart (16-byte aligned rows whose
// stride spreads the rows of a warp's vector loads over the banks).
//   ring slot (prep writes; carry and y warps read), nslot of them:
//     r_dec C*LD | k_carry C*LD | exp(clw_last) HM | y_intra C*JT | v C*JT
//   prep:    running decays C*LD | k_dec C*LD | r.u.k C*LD | att C*C
//   state:   NS copies of S's slice, transposed: JT rows of LD
//   raw:     nstage cp.async stages of r, k, w (C x hs) and v (C x JT), in
//            their own dtypes
template <typename T, typename TW, int HM> struct Layout {
  static constexpr int LD = HM + 4;
  int C, hs, nslot, nstage;
  __host__ __device__ Layout(int C_, int hs_, int nslot_, int nstage_)
      : C(C_), hs(hs_), nslot(nslot_), nstage(nstage_) {}
  __host__ __device__ int slot_floats() const { return 2 * C * LD + HM + 2 * C * JT; }
  __host__ __device__ int prep_floats() const { return 3 * C * LD + ((C * C + 3) & ~3); }
  __host__ __device__ int state_floats() const { return NS * JT * LD; }
  __host__ __device__ int prep_offset() const { return nslot * slot_floats(); }
  __host__ __device__ int state_offset() const { return prep_offset() + prep_floats(); }
  __host__ __device__ int raw_offset_bytes() const {
    return NBAR * 8 + 4 * (state_offset() + state_floats());
  }
  // one stage: r, k, w rows of hs elements, then v's JT columns
  __host__ __device__ int raw_rk_bytes() const { return round16(C * hs * (int)sizeof(T)); }
  __host__ __device__ int raw_w_bytes() const { return round16(C * hs * (int)sizeof(TW)); }
  __host__ __device__ int raw_v_bytes() const { return round16(C * JT * (int)sizeof(T)); }
  __host__ __device__ int stage_bytes() const {
    return 2 * raw_rk_bytes() + raw_w_bytes() + raw_v_bytes();
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)raw_offset_bytes() + (size_t)nstage * stage_bytes();
  }
};

struct Barriers {
  uint64_t *full, *empty;    // ring slots: prep -> carry and y
  uint64_t *sfull, *sempty;  // state copies: carry -> y
};

template <typename T>
__device__ __forceinline__ float ld(const T* base, int64_t off) {
  return to_f32(base[off]);
}
__device__ __forceinline__ void prep_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NPREP) : "memory");
}
// Wait until at most n (0 to 2) of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
__device__ __forceinline__ float sum4(float4 a) { return (a.x + a.y) + (a.z + a.w); }

template <typename T, typename TW, int HM>
__device__ __forceinline__ void prep_role(const WkvArgs& a, float* base, uint8_t* raw,
                                          const Barriers& bar, int nslot, int nstage, int j0,
                                          int h, int b) {
  using L = Layout<T, TW, HM>;
  constexpr int LD = L::LD;
  const int C = a.C, hs = a.hs, p = threadIdx.x;
  const L lay(C, hs, nslot, nstage);
  float* __restrict__ cum = base + lay.prep_offset();
  float* __restrict__ kdec = cum + C * LD;
  float* __restrict__ ruk = kdec + C * LD;
  float* __restrict__ att = ruk + C * LD;
  const int jn = min(JT, hs - j0);  // this block's columns

  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const TW* w = static_cast<const TW*>(a.w);
  const int64_t rb = b * a.st[0][0] + h * a.st[0][2], rt = a.st[0][1];
  const int64_t kb = b * a.st[1][0] + h * a.st[1][2], kt = a.st[1][1];
  const int64_t vb = b * a.st[2][0] + h * a.st[2][2] + j0, vt = a.st[2][1];
  const int64_t wb = b * a.st[3][0] + h * a.st[3][2], wt = a.st[3][1];

  // The raw copy: thread p < 4 C copies row p % C of r, k, w or v (p / C)
  // by 16-byte cp.async; only the chunk's first row moves from chunk
  // to chunk.  One commit group per chunk, into stage c % nstage.
  const uint8_t* cp_src = nullptr;
  int64_t cp_step = 0;  // bytes from one chunk's row to the next chunk's
  int cp_bytes = 0, cp_dst = 0;
  if (p < 4 * C) {
    const int arr = p / C, row = p % C;
    const int es = sizeof(T), ew = sizeof(TW);
    const void* src[4] = {r + rb + (int64_t)row * rt, k + kb + (int64_t)row * kt,
                          w + wb + (int64_t)row * wt, v + vb + (int64_t)row * vt};
    const int64_t step[4] = {C * rt * es, C * kt * es, C * wt * ew, C * vt * es};
    const int bytes[4] = {hs * es, hs * es, hs * ew, jn * es};
    const int dst[4] = {row * hs * es, lay.raw_rk_bytes() + row * hs * es,
                        2 * lay.raw_rk_bytes() + row * hs * ew,
                        2 * lay.raw_rk_bytes() + lay.raw_w_bytes() + row * jn * es};
    cp_src = static_cast<const uint8_t*>(src[arr]);
    cp_step = step[arr];
    cp_bytes = bytes[arr];
    cp_dst = dst[arr];
  }
  auto fetch = [&](int c) {
    if ((int64_t)c * C < a.T && cp_bytes > 0) {
      uint8_t* dst = raw + (c % nstage) * lay.stage_bytes() + cp_dst;
      const uint8_t* src = cp_src + c * cp_step;
      for (int o = 0; o < cp_bytes; o += 16) cp_async16(dst + o, src + o, true);
    }
    cp_async_commit();
  };

  static_assert(NPREP % HM == 0, "every prep thread keeps one channel");
  const int my_ch = p % HM;  // the channel of every element this thread touches
  const bool my_ok = my_ch < hs;
  const float my_u = my_ok ? a.u[(int64_t)h * hs + my_ch] : 0.f;

  // pads stay zero: channels hs..HM of every row, for every chunk
  for (int x = p; x < lay.prep_floats(); x += NPREP) cum[x] = 0.f;

  for (int c = 0; c + 1 < nstage; ++c) fetch(c);
  int slot = 0;
  uint32_t phase = 0;
  for (int c = 0, c0 = 0; c0 < a.T; ++c, c0 += C) {
    mbar_wait(&bar.empty[slot], phase ^ 1);
    float* __restrict__ rdec = base + slot * lay.slot_floats();
    float* __restrict__ kc = rdec + C * LD;
    float* __restrict__ av = kc + C * LD;
    float* __restrict__ yi = av + HM;
    float* __restrict__ vs = yi + C * JT;
    const uint8_t* st = raw + (nstage > 0 ? (c % nstage) * lay.stage_bytes() : 0);
    const T* __restrict__ r_raw = reinterpret_cast<const T*>(st);
    const T* __restrict__ k_raw = reinterpret_cast<const T*>(st + lay.raw_rk_bytes());
    const TW* __restrict__ w_raw = reinterpret_cast<const TW*>(st + 2 * lay.raw_rk_bytes());
    const T* __restrict__ v_raw =
        reinterpret_cast<const T*>(st + 2 * lay.raw_rk_bytes() + lay.raw_w_bytes());
    if (nstage > 0) {
      fetch(c + nstage - 1);  // into the stage read one chunk ago
      cp_async_wait_upto(nstage - 1);
    }
    prep_sync();  // the stage has landed for every thread; the slot is free

    // 1a. per channel, one thread, in order: the cumulative decay
    //     P_t = exp(clw_t), a running product of max(w, 1e-30), into `cum`;
    //     P_last into the slot.  This block's columns of v into the slot.
    if (p < HM) {
      float run = 1.f;
#pragma unroll 8
      for (int s = 0; s < C; ++s) {
        float wv = 1.f;
        if (my_ok)
          wv = fmaxf(nstage > 0 ? to_f32(w_raw[s * hs + my_ch])
                                : ld(w, wb + (int64_t)(c0 + s) * wt + my_ch), 1e-30f);
        run *= wv;
        cum[s * LD + my_ch] = run;
      }
      av[my_ch] = run;
    }
    for (int x = p; x < C * JT; x += NPREP) {
      const int s = x / JT, jj = x % JT;
      float val = 0.f;
      if (jj < jn)
        val = nstage > 0 ? to_f32(v_raw[s * jn + jj]) : ld(v, vb + (int64_t)(c0 + s) * vt + jj);
      vs[x] = val;
    }
    prep_sync();

    // 1b. every element: exp(clw_{t-1}) = P_{t-1} and
    //     exp(min(-clw_t, 60)) = min(1 / P_t, exp(60)) make the decayed terms
    {
      const float last = av[my_ch];
#pragma unroll 4
      for (int x = p; x < C * HM; x += NPREP) {
        const int s = x / HM;
        const float cu = cum[s * LD + my_ch];
        const float prev = s > 0 ? cum[(s - 1) * LD + my_ch] : 1.f;
        float rr = 0.f, kk = 0.f;
        if (my_ok) {
          rr = nstage > 0 ? to_f32(r_raw[s * hs + my_ch])
                          : ld(r, rb + (int64_t)(c0 + s) * rt + my_ch);
          kk = nstage > 0 ? to_f32(k_raw[s * hs + my_ch])
                          : ld(k, kb + (int64_t)(c0 + s) * kt + my_ch);
        }
        const float e = fminf(1.f / cu, EXP60);
        rdec[s * LD + my_ch] = rr * prev;
        kdec[s * LD + my_ch] = kk * e;
        kc[s * LD + my_ch] = kk * (last * e);
        ruk[s * LD + my_ch] = rr * my_u * kk;
      }
    }
    prep_sync();

    // 2. intra-chunk matrix, lower triangle, in 4x4 blocks of (t, s) with the
    //    depth split over KS adjacent lanes: r_dec . k_dec below the
    //    diagonal, the bonus sum of r.u.k on it.  The upper triangle is never
    //    read.
    {
      const int CB = (C + 3) / 4, items = CB * CB * KS;
      constexpr int DK = HM / KS;
      for (int i0 = 0; i0 < items; i0 += NPREP) {
        const int item = i0 + p, kp = item % KS, blk = item / KS;
        const int tb = blk / CB, sb = blk % CB;
        const bool live = item < items && sb <= tb, diag = tb == sb;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        if (live) {
          const float4* rr[4];
          const float4* kk[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            rr[i] = reinterpret_cast<const float4*>(rdec + min(4 * tb + i, C - 1) * LD + kp * DK);
            kk[i] = reinterpret_cast<const float4*>(kdec + min(4 * sb + i, C - 1) * LD + kp * DK);
          }
#pragma unroll
          for (int x = 0; x < DK / 4; ++x) {
            float4 rv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              rv[i] = rr[i][x];
              kv[i] = kk[i][x];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = dot4(rv[i], kv[j], acc[i][j]);
          }
          if (diag) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4* u4 =
                  reinterpret_cast<const float4*>(ruk + min(4 * tb + i, C - 1) * LD + kp * DK);
              float bonus = 0.f;
#pragma unroll
              for (int x = 0; x < DK / 4; ++x) bonus += sum4(u4[x]);
              acc[i][i] = bonus;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int o = 1; o < KS; o <<= 1)
              acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
        if (live && kp == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int t = 4 * tb + i, s = 4 * sb + j;
              if (t < C && s <= t) att[t * C + s] = acc[i][j];
            }
        }
      }
    }
    prep_sync();

    // 3. y_intra = att @ v for this block's columns, two partial sums (a
    //    warp reads two rows of att, broadcast, and consecutive columns of v)
    for (int x = p; x < C * JT; x += NPREP) {
      const int t = x / JT, jj = x % JT;
      float acc0 = 0.f, acc1 = 0.f;
      int s = 0;
#pragma unroll 4
      for (; s + 1 <= t; s += 2) {
        acc0 = fmaf(att[t * C + s], vs[s * JT + jj], acc0);
        acc1 = fmaf(att[t * C + s + 1], vs[(s + 1) * JT + jj], acc1);
      }
      if (s <= t) acc0 = fmaf(att[t * C + s], vs[s * JT + jj], acc0);
      yi[x] = acc0 + acc1;
    }
    mbar_arrive(&bar.full[slot]);
    if (++slot == nslot) { slot = 0; phase ^= 1; }
  }
  cp_async_wait<0>();
}

// The serial chain: S (rows ig*RI .. ig*RI + RI - 1 of column `col` in this
// lane's registers) handed to the y warps, then carried to the chunk's end.
template <typename T, typename TW, int HM>
__device__ __forceinline__ void carry_role(const WkvArgs& a, float* base, const Barriers& bar,
                                           int nslot, int nstage, int j0, int h, int b) {
  using L = Layout<T, TW, HM>;
  constexpr int LD = L::LD, RI = HM / IG;
  const L lay(a.C, a.hs, nslot, nstage);
  const int C = a.C, hs = a.hs;
  const int q = threadIdx.x - NPREP, lane = q & 31;
  const int col = (q >> 5) * 4 + (lane & 3), ig = lane >> 2;
  const int j = j0 + col, i0 = ig * RI;
  const bool jok = j < hs;
  const int64_t sbase = ((int64_t)b * a.H + h) * hs * hs;
  float* St = base + lay.state_offset();  // NS transposed copies: [column][row]

  float S[RI];
#pragma unroll
  for (int x = 0; x < RI; ++x)
    S[x] = (a.state0 != nullptr && jok && i0 + x < hs) ? a.state0[sbase + (int64_t)(i0 + x) * hs + j]
                                                      : 0.f;
  int slot = 0, sc = 0;
  uint32_t phase = 0, sphase = 0;
  for (int c0 = 0; c0 < a.T; c0 += C) {
    // the state entering this chunk, for the y warps
    mbar_wait(&bar.sempty[sc], sphase ^ 1);
#pragma unroll
    for (int x = 0; x < RI / 4; ++x)
      reinterpret_cast<float4*>(St + sc * JT * LD + col * LD + i0)[x] =
          make_float4(S[4 * x], S[4 * x + 1], S[4 * x + 2], S[4 * x + 3]);
    mbar_arrive(&bar.sfull[sc]);
    if (++sc == NS) { sc = 0; sphase ^= 1; }

    mbar_wait(&bar.full[slot], phase);
    const float* kc = base + slot * lay.slot_floats() + C * LD;
    const float* av = kc + C * LD;
    const float* vs = av + HM + C * JT;
    {
      const float4* a4 = reinterpret_cast<const float4*>(av + i0);
#pragma unroll
      for (int x = 0; x < RI / 4; ++x) {
        const float4 d = a4[x];
        S[4 * x] *= d.x;
        S[4 * x + 1] *= d.y;
        S[4 * x + 2] *= d.z;
        S[4 * x + 3] *= d.w;
      }
    }
#pragma unroll 4
    for (int s = 0; s < C; ++s) {
      const float vv = vs[s * JT + col];
      const float4* k4 = reinterpret_cast<const float4*>(kc + s * LD + i0);
#pragma unroll
      for (int x = 0; x < RI / 4; ++x) {
        const float4 kv = k4[x];
        S[4 * x] = fmaf(kv.x, vv, S[4 * x]);
        S[4 * x + 1] = fmaf(kv.y, vv, S[4 * x + 1]);
        S[4 * x + 2] = fmaf(kv.z, vv, S[4 * x + 2]);
        S[4 * x + 3] = fmaf(kv.w, vv, S[4 * x + 3]);
      }
    }
    mbar_arrive(&bar.empty[slot]);
    if (++slot == nslot) { slot = 0; phase ^= 1; }
  }

  if (a.state_out != nullptr && jok) {
#pragma unroll
    for (int x = 0; x < RI; ++x)
      if (i0 + x < hs) a.state_out[sbase + (int64_t)(i0 + x) * hs + j] = S[x];
  }
}

// y = y_intra + r_dec @ S for each chunk, from the carry warps' copy of the
// state entering it: rows t and t + 8 of column jj a pass.
template <typename T, typename TW, typename TO, int HM>
__device__ __forceinline__ void y_role(const WkvArgs& a, float* base, const Barriers& bar,
                                       int nslot, int nstage, int j0, int h, int b) {
  using L = Layout<T, TW, HM>;
  constexpr int LD = L::LD;
  const L lay(a.C, a.hs, nslot, nstage);
  const int C = a.C, hs = a.hs;
  const int q = threadIdx.x - NPREP - NCARRY;
  const int jj = q % JT, tb = q / JT;
  const bool yok = j0 + jj < hs;
  TO* y = static_cast<TO*>(a.y);
  const float* St = base + lay.state_offset();

  int slot = 0, sc = 0;
  uint32_t phase = 0, sphase = 0;
  for (int c0 = 0; c0 < a.T; c0 += C) {
    mbar_wait(&bar.full[slot], phase);
    mbar_wait(&bar.sfull[sc], sphase);
    const float* rdec = base + slot * lay.slot_floats();
    const float* yi = rdec + 2 * C * LD + HM;
    const float4* s4 = reinterpret_cast<const float4*>(St + sc * JT * LD + jj * LD);
    for (int t = tb; t < C; t += 2 * IG) {
      const int t1 = min(t + IG, C - 1);
      const float4* r0 = reinterpret_cast<const float4*>(rdec + t * LD);
      const float4* r1 = reinterpret_cast<const float4*>(rdec + t1 * LD);
      float p0[2] = {0.f, 0.f}, p1[2] = {0.f, 0.f};
#pragma unroll
      for (int x = 0; x < HM / 4; ++x) {
        const float4 sv = s4[x];
        p0[x & 1] = dot4(r0[x], sv, p0[x & 1]);
        p1[x & 1] = dot4(r1[x], sv, p1[x & 1]);
      }
      if (yok) {
        y[(((int64_t)b * a.T + c0 + t) * a.H + h) * hs + j0 + jj] =
            from_f32<TO>(yi[t * JT + jj] + (p0[0] + p0[1]));
        if (t + IG < C)
          y[(((int64_t)b * a.T + c0 + t + IG) * a.H + h) * hs + j0 + jj] =
              from_f32<TO>(yi[(t + IG) * JT + jj] + (p1[0] + p1[1]));
      }
    }
    mbar_arrive(&bar.sempty[sc]);
    if (++sc == NS) { sc = 0; sphase ^= 1; }
    mbar_arrive(&bar.empty[slot]);
    if (++slot == nslot) { slot = 0; phase ^= 1; }
  }
}

template <typename T, typename TW, typename TO, int HM>
__global__ void __launch_bounds__(NT) wkv_chunk_kernel(WkvArgs a, int nslot, int nstage) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  const Barriers bar{bars, bars + 2, bars + 4, bars + 6};
  float* base = reinterpret_cast<float*>(smem_raw + NBAR * 8);
  const Layout<T, TW, HM> lay(a.C, a.hs, nslot, nstage);
  uint8_t* raw = smem_raw + lay.raw_offset_bytes();
  const int j0 = blockIdx.x * JT, h = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar.full[s], NPREP);
      mbar_init(&bar.empty[s], NCARRY + NY);
      mbar_init(&bar.sfull[s], NCARRY);
      mbar_init(&bar.sempty[s], NY);
    }
  }
  __syncthreads();
  if (threadIdx.x < NPREP)
    prep_role<T, TW, HM>(a, base, raw, bar, nslot, nstage, j0, h, b);
  else if (threadIdx.x < NPREP + NCARRY)
    carry_role<T, TW, HM>(a, base, bar, nslot, nstage, j0, h, b);
  else
    y_role<T, TW, TO, HM>(a, base, bar, nslot, nstage, j0, h, b);
}

// The deepest rings that fit: two slots and three raw stages at the served
// shape; without cp.async alignment, no stages (plain loads).
template <typename T, typename TW, int HM>
bool pick_rings(const WkvArgs& a, int* nslot, int* nstage) {
  static const int options[][2] = {{2, 3}, {2, 2}, {1, 2}, {1, 1}, {2, 0}, {1, 0}};
  for (const auto& o : options) {
    if (o[1] > 0 && !a.staged) continue;
    if (Layout<T, TW, HM>(a.C, a.hs, o[0], o[1]).bytes() <= SMEM_MAX) {
      *nslot = o[0];
      *nstage = o[1];
      return true;
    }
  }
  return false;
}

template <typename T, typename TW, typename TO, int HM>
int launch(const WkvArgs& a, int B, cudaStream_t stream) {
  auto kern = wkv_chunk_kernel<T, TW, TO, HM>;
  int nslot, nstage;
  if (!pick_rings<T, TW, HM>(a, &nslot, &nstage)) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<T, TW, HM>(a.C, a.hs, nslot, nstage).bytes();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.hs + JT - 1) / JT, a.H, B);
  kern<<<grid, NT, smem, stream>>>(a, nslot, nstage);
  return (int)cudaGetLastError();
}

template <typename T, typename TW, typename TO>
int launch_hs(const WkvArgs& a, int B, cudaStream_t s) {
  if (a.hs <= 64) return launch<T, TW, TO, 64>(a, B, s);
  if (a.hs <= 128) return launch<T, TW, TO, 128>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename TW>
int launch_out(int out_dtype, const WkvArgs& a, int B, cudaStream_t s) {
  if (out_dtype == 0) return launch_hs<T, TW, float>(a, B, s);
  if (out_dtype == 1) return launch_hs<T, TW, bf16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_w(int w_dtype, int out_dtype, const WkvArgs& a, int B, cudaStream_t s) {
  if (w_dtype == 0) return launch_out<T, float>(out_dtype, a, B, s);
  if (w_dtype == 1) return launch_out<T, bf16>(out_dtype, a, B, s);
  return (int)cudaErrorInvalidValue;
}

// Whether every row of r, k, w and every 16-column tile of v can be copied
// by 16-byte cp.async: aligned bases and strides, rows a whole number of
// copies long.
bool rows_aligned16(const void* const* ptrs, const int* esize, const int64_t* strides, int hs) {
  for (int x = 0; x < 4; ++x) {
    const int64_t es = esize[x];
    if ((uintptr_t)ptrs[x] % 16 || (hs * es) % 16 || (JT * es) % 16) return false;
    for (int d = 0; d < 3; ++d)
      if ((strides[3 * x + d] * es) % 16) return false;
  }
  return true;
}

}  // namespace

// dtype codes: 0 = f32, 1 = bf16 (r/k/v share one; w and y may differ).
// r/k/v/w (B,T,H,hs) with a unit last stride and the (b, t, h) element strides
// of each in `strides` (12 values, r k v w in turn); u (H,hs) f32 contiguous;
// state0 and state_out (B,H,hs,hs) f32 contiguous or null; y (B,T,H,hs)
// contiguous.  hs <= 128, T % C == 0, C <= 64.  Returns the cudaError_t.
extern "C" int frontier_wkv_chunked(const void* r, const void* k, const void* v, const void* w,
                                    const void* u, const void* state0, void* y, void* state_out,
                                    int dtype, int w_dtype, int out_dtype, int B, int T, int H,
                                    int hs, int C, const int64_t* strides, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || hs <= 0) return 0;
  if (C <= 0 || C > 64 || T % C != 0 || hs > 128) return (int)cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 1 || w_dtype < 0 || w_dtype > 1) return (int)cudaErrorInvalidValue;
  WkvArgs a;
  a.r = r; a.k = k; a.v = v; a.w = w;
  a.u = (const float*)u;
  a.state0 = (const float*)state0;
  a.y = y;
  a.state_out = (float*)state_out;
  for (int x = 0; x < 4; ++x)
    for (int d = 0; d < 3; ++d) a.st[x][d] = strides[3 * x + d];
  a.T = T; a.H = H; a.hs = hs; a.C = C;
  const void* ptrs[4] = {r, k, v, w};
  const int es = dtype == 0 ? 4 : 2, ew = w_dtype == 0 ? 4 : 2;
  const int esize[4] = {es, es, es, ew};
  a.staged = rows_aligned16(ptrs, esize, strides, hs);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_w<float>(w_dtype, out_dtype, a, B, s);
  return launch_w<bf16>(w_dtype, out_dtype, a, B, s);
}
