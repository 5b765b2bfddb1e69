// Paged-KV decode attention for Hopper (sm_90a), bf16 or int8 pages, fp32
// math: split-KV (flash-decoding) over a cp.async ring of page tiles.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py,
// * paged_decode_attention (the Pallas `_kernel`, launched by the
//   pallas_call at line 215): bf16 pages, paged_decode_attention_bf16 below;
// * paged_decode_attention_q8 (the Pallas `_kernel_q8`, launched by the
//   pallas_call at line 296): int8 pages with one f32 scale per (page, kv
//   head, slot) for K and for V, paged_decode_attention_q8 below.
// Both are one template, paged_decode_split_kernel<T, G>, on the page
// element type T and a bound G on the query heads of a kv head.
//
// Computes, per batch row b and query head h:
//   out[b, h] = softmax(q[b, h] . K_b^T * sm_scale) . V_b
// where K_b / V_b are the first lens[b] slots of the row's pages, looked up
// through tables[b, :] in a shared pool [num_pages, nkv, page, d].  Table
// entries past ceil(lens[b] / page) point at the junk page 0; they are never
// read.  A row with lens[b] == 0 writes zeros.  With int8 pages K_b and V_b
// are codes times their slot's scale; as in the TPU kernel the scales are
// folded into the logits (q . (k * ks) = (q . k) * ks) and into the
// probabilities (sum p * (v * vs) = sum (p * vs) * v), so no d-wide dequant
// is done.
//
// What bounds it on the card: bytes.  One decode token does 4*d FLOPs per
// (head, key) pair against 4*d bytes of bf16 K and V (2*d of int8, plus 8
// bytes of scales) per (kv head, key): about g = n/nkv FLOPs per byte (2g for
// int8), far below the ~295 FLOPs/byte where an H100's bf16 tensor cores
// would be the limit.  The floor is reading every used K/V byte of the pool
// once at 3.35 TB/s; int8 pages halve it.  Reaching it takes many loads in
// flight on every SM at once.
//
// What the design does about it (the TPU kernel walks a row's pages as a
// sequential grid and lets Mosaic's DMA pipeline hide the loads; here blocks
// run in parallel and nothing pipelines a loop for us):
// * Split-KV.  The grid is (S, nkv, B): block (s, kvh, b) covers the row's
//   tokens [s * split_tokens, (s + 1) * split_tokens), split_tokens a whole
//   number of pages.  The wrapper picks S and the pages of a split from the
//   shapes and the SM count alone, never from lens (a length lives on the
//   card: reading it would be a sync, and would keep the call out of a CUDA
//   graph).  A block whose split starts past its row's end exits at once.  A
//   long row's pages are so spread over many blocks, and the kernel no longer
//   lasts as long as the longest row's page chain.  Each block writes its
//   split's (m, l, acc) in f32; paged_decode_combine_kernel merges a (row,
//   head)'s used splits in index order with the log-sum-exp rule, so the
//   result is the same bits from run to run.  With S == 1 the split kernel
//   writes the output itself and no combine is launched.
// * A ring of kStages tiles in shared memory, each kTile slots of K and V
//   (32 bf16 or 64 int8 slots: 64 bytes a head_dim element, 16 KB a stage at
//   d = 128), filled with 16-byte cp.async copies (the int8 scales with
//   4-byte ones).  The copies of tile j + kStages - 1 are issued before tile j
//   is computed on, so kStages - 1 tiles are in flight while the scores, the
//   softmax and P . V run.  A tile is a run of slots, not a page, so shared
//   memory does not grow with the page size.
// * Every thread works in each phase.  Scores: a key's 16-byte chunks spread
//   over a power-of-two group of lanes (16 lanes at d = 128 bf16, 8 at int8),
//   so a warp scores 2 (bf16) or 4 (int8) keys a step and sums each dot
//   product with shuffles.  P . V: each thread owns kVC columns of the head
//   dim (8 up to g = 4, 2 at g = 16) for one key in KP; the KP partial sums
//   are added in a fixed order at the end.  The online-softmax state (m, l,
//   acc) lives in registers; every thread derives the same running max from
//   four per-warp maxima, so the softmax needs no phase of its own.
// * The g query heads of a GQA group share the block, so each K/V tile is
//   read from device memory once for the whole group.
// * A block loads q beside its row's length and stages its split's table
//   entries in shared memory once, so no copy waits on a global load for its
//   address.  The kernel asks for the whole L1 / shared array as shared
//   memory, so the ring's size alone sets the blocks an SM holds (four at
//   d = 128).
// * exp2 in one ex2.approx instruction, with log2(e) folded into sm_scale;
//   int8 codes widen to f32 with a byte permute and one add (2^23 + code +
//   128, exact), not a conversion instruction.
// Tensor cores are not used: at g <= 16 FLOPs a byte the work is far from
// their line.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;           // ring depth: kStages - 1 tiles in flight
constexpr float kNegInf = -1e30f;    // NEG_INF of the JAX kernels
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__host__ __device__ constexpr bool is_q8() { return sizeof(T) == 1; }
// elements of one 16-byte copy, and slots of one ring tile (64 bytes a
// head_dim element)
template <typename T>
__host__ __device__ constexpr int chunk_elems() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int tile_slots() { return 64 / (int)sizeof(T); }
// head_dim columns a thread owns in P . V (at most 8): its accumulator is
// G * kVC floats
template <int G>
__host__ __device__ constexpr int pv_cols() {
  return 32 / G < 8 ? 32 / G : 8;
}
// blocks an SM the register budget is set for: 512 threads (128 registers
// a thread) up to a group of 8, 256 for 16 heads, whose scores and
// accumulators take more
template <int G>
__host__ __device__ constexpr int min_blocks() {
  return (G <= 8 ? 512 : 256) / kThreads;
}
// the q chunk of a lane stays in registers when it is small
template <typename T, int G>
__host__ __device__ constexpr bool q_in_regs() { return G * chunk_elems<T>() <= 32; }

// 2^x in one MUFU instruction (denormal results flush to 0); x <= 0 here
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One int8 code of the 32-bit word w (byte `which`) as f32: the byte, offset
// to unsigned by ^ 0x80, becomes the mantissa of 2^23, and 2^23 + 128 comes
// off again; exact.
__device__ __forceinline__ float i8_at(unsigned w, int which) {
  const unsigned x = w ^ 0x80808080u;
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 | which)) -
         8388736.f;
}

// The elements packed in NW 32-bit words as f32 (2 bf16 or 4 int8 a word)
template <typename T, int NW>
__device__ __forceinline__ void words_f32(const unsigned (&w)[NW], float* f) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if constexpr (is_q8<T>()) {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[4 * i + e] = i8_at(w[i], e);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// N consecutive elements at p (N * sizeof(T) bytes, as aligned) as f32
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* f) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    words_f32<T, 4>(w, f);
  } else if constexpr (kBytes == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const unsigned w[2] = {v.x, v.y};
    words_f32<T, 2>(w, f);
  } else if constexpr (kBytes == 4) {
    const unsigned w[1] = {*reinterpret_cast<const unsigned*>(p)};
    words_f32<T, 1>(w, f);
  } else {  // two int8 codes
    const unsigned w = *reinterpret_cast<const unsigned short*>(p);
    f[0] = i8_at(w, 0);
    f[1] = i8_at(w, 1);
  }
}

// Shared memory of one split block, in bytes: the ring (reused by the final
// reduction across the KP key groups) + q in f32 + the tile's scores + the
// per-warp maxima and the running max read by the epilogue + the split's
// table entries.
template <typename T>
__host__ __device__ int ring_bytes(int d) {
  return kStages * (2 * tile_slots<T>() * d * (int)sizeof(T) +
                    (is_q8<T>() ? 2 * tile_slots<T>() * 4 : 0));
}

template <int G>
__host__ __device__ int red_bytes(int g, int d) {
  const int kp = kThreads / (d / pv_cols<G>());
  return (kp * g * (d + 1) * 4 + 15) / 16 * 16;
}

template <typename T, int G>
size_t smem_bytes(int g, int d, int split_pages) {
  const int ring = ring_bytes<T>(d), red = red_bytes<G>(g, d);
  return (size_t)(ring > red ? ring : red) +
         (size_t)g * d * 4 + (size_t)g * tile_slots<T>() * 4 +
         (size_t)(kWarps + 1) * g * 4 + (size_t)split_pages * 4;
}

// kscale / vscale: [num_pages, nkv, page] f32 for int8 pages, unused (null)
// for bf16 ones.  part: with S > 1, the splits' f32 partials
// [B * n, S, d] (acc), then [B * n, S] (m, log2 domain), then [B * n, S] (l).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, min_blocks<G>())
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const T* __restrict__ kpool,
                          const T* __restrict__ vpool,
                          const float* __restrict__ kscale,
                          const float* __restrict__ vscale,
                          const int* __restrict__ tables,
                          const int* __restrict__ lens,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ part,
                          int n, int nkv, int d, int page, int pages_max,
                          int split_pages, float scale_log2) {
  constexpr bool kQ8 = is_q8<T>();
  constexpr int kChunk = chunk_elems<T>();
  constexpr int kTile = tile_slots<T>();
  constexpr int kVC = pv_cols<G>();
  constexpr bool kQRegs = q_in_regs<T, G>();
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x;
  const int g = n / nkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // q's 16-byte chunks are loaded beside the row's length: neither waits
  // for the other
  constexpr int kQLoads = (G * 256 / 8 + kThreads - 1) / kThreads;
  const uint4* qg = reinterpret_cast<const uint4*>(
      q + ((size_t)b * n + (size_t)kvh * g) * d);
  const int qchunks = g * d / 8;
  uint4 qv[kQLoads];
#pragma unroll
  for (int i = 0; i < kQLoads; ++i)
    if (tid + i * kThreads < qchunks) qv[i] = qg[tid + i * kThreads];
  const int len = min(lens[b], pages_max * page);
  const int split_tokens = split_pages * page;
  const int start = split * split_tokens;
  if (S > 1 && start >= len) return;   // an empty split; the combine skips it
  const int end = min(len, start + split_tokens);
  const int ntiles = (max(end - start, 0) + kTile - 1) / kTile;

  // scores: a key's C chunks over L lanes (L the power of two >= C), KPW keys
  // a warp step, kSU steps at once so their shuffles overlap
  constexpr int kSU = G >= 4 ? 1 : 4 / G;
  const int C = d / kChunk;
  int lgL = 0;
  while ((1 << lgL) < C) ++lgL;
  const int L = 1 << lgL;
  const int KPW = 32 >> lgL;
  const int nsteps = (kTile + kWarps * KPW - 1) / (kWarps * KPW);
  const int c = lane & (L - 1);
  // P . V: thread (kp, tc) owns columns [tc * kVC, (tc + 1) * kVC) of keys
  // kp, kp + KP, ...
  const int TP = d / kVC;
  const int KP = kThreads / TP;
  const int kp = tid / TP;
  const int tc = tid - kp * TP;

  extern __shared__ __align__(16) unsigned char smem[];
  const int ring = ring_bytes<T>(d), red = red_bytes<G>(g, d);
  const int stage_bytes = ring / kStages;
  float* qs = reinterpret_cast<float*>(smem + (ring > red ? ring : red));
  float* ss = qs + g * d;               // [g, kTile] scores (log2 domain)
  float* wm = ss + g * kTile;           // [kWarps, g] per-warp tile maxima
  float* mfin = wm + kWarps * g;        // [g] running max for the epilogue
  int* tsm = reinterpret_cast<int*>(mfin + g);   // the split's page ids

#pragma unroll
  for (int i = 0; i < kQLoads; ++i) {
    const int at = tid + i * kThreads;
    if (at < qchunks) {
      const unsigned w[4] = {qv[i].x, qv[i].y, qv[i].z, qv[i].w};
      float f[8];
      words_f32<__nv_bfloat16, 4>(w, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) qs[at * 8 + e] = f[e];
    }
  }
  // the split's used table entries, once: the ring's copies then wait on no
  // global load for their addresses
  const int npages = (max(end - start, 0) + page - 1) / page;
  const int* trow = tables + (size_t)b * pages_max + start / page;
  for (int i = tid; i < npages; i += kThreads) tsm[i] = trow[i];
  __syncthreads();  // qs and tsm written

  // issue the copies of tile t (if it exists) into its stage; one commit
  // group a call either way, so the wait counts stay uniform
  auto issue = [&](int t) {
    if (t < ntiles) {
      const int tok0 = t * kTile;          // from the split's start
      const int nvalid = min(kTile, end - start - tok0);
      unsigned char* st = smem + (t % kStages) * stage_bytes;
      T* kd = reinterpret_cast<T*>(st);
      T* vd = kd + kTile * d;
      for (int i = tid; i < (nvalid << lgL); i += kThreads) {
        const int r = i >> lgL, cc = i & (L - 1);
        if (cc >= C) continue;
        const int tok = tok0 + r;
        const int j = tok / page;
        const size_t row =
            (((size_t)tsm[j] * nkv + kvh) * page + (tok - j * page)) * d +
            (size_t)cc * kChunk;
        cp_async16(kd + r * d + cc * kChunk, kpool + row);
        cp_async16(vd + r * d + cc * kChunk, vpool + row);
      }
      if constexpr (kQ8) {
        float* ksd = reinterpret_cast<float*>(vd + kTile * d);
        float* vsd = ksd + kTile;
        for (int r = tid; r < nvalid; r += kThreads) {
          const int tok = tok0 + r;
          const int j = tok / page;
          const size_t at =
              ((size_t)tsm[j] * nkv + kvh) * page + (tok - j * page);
          cp_async4(ksd + r, kscale + at);
          cp_async4(vsd + r, vscale + at);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);

  float qr[kQRegs ? G : 1][kQRegs ? kChunk : 1];
  if constexpr (kQRegs) {
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        qr[h][e] = (h < g && c < C) ? qs[h * d + c * kChunk + e] : 0.f;
  }

  float m[G], lsum[G], acc[G][kVC];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    lsum[h] = 0.f;
#pragma unroll
    for (int e = 0; e < kVC; ++e) acc[h][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for every thread; tile t - 1 is done
    issue(t + kStages - 1);  // into tile t - 1's stage

    const int nvalid = min(kTile, end - (start + t * kTile));
    const unsigned char* st = smem + (t % kStages) * stage_bytes;
    const T* kt = reinterpret_cast<const T*>(st);
    const T* vt = kt + kTile * d;
    const float* kst = reinterpret_cast<const float*>(vt + kTile * d);
    const float* vst = kst + kTile;

    // scores, and each warp's max of them per head
    float mx[G];
#pragma unroll
    for (int h = 0; h < G; ++h) mx[h] = kNegInf;
    for (int s0 = 0; s0 < nsteps; s0 += kSU) {
      float dot[kSU][G];
#pragma unroll
      for (int u = 0; u < kSU; ++u) {
        const int r = ((s0 + u) * kWarps + warp) * KPW + (lane >> lgL);
#pragma unroll
        for (int h = 0; h < G; ++h) dot[u][h] = 0.f;
        if (s0 + u < nsteps && r < nvalid && c < C) {
          float kf[kChunk];
          load_f32<T, kChunk>(kt + r * d + c * kChunk, kf);
#pragma unroll
          for (int h = 0; h < G; ++h) {
            if (h >= g) continue;
#pragma unroll
            for (int e = 0; e < kChunk; ++e) {
              float qv;
              if constexpr (kQRegs) qv = qr[h][e];
              else qv = qs[h * d + c * kChunk + e];
              dot[u][h] = fmaf(qv, kf[e], dot[u][h]);
            }
          }
        }
      }
      for (int o = L >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kSU; ++u)
#pragma unroll
          for (int h = 0; h < G; ++h)
            dot[u][h] += __shfl_xor_sync(0xffffffffu, dot[u][h], o);
      }
#pragma unroll
      for (int u = 0; u < kSU; ++u) {
        const int r = ((s0 + u) * kWarps + warp) * KPW + (lane >> lgL);
        if (s0 + u < nsteps && r < nvalid) {
          const float kscl = kQ8 ? scale_log2 * kst[r] : scale_log2;
#pragma unroll
          for (int h = 0; h < G; ++h) {
            if (h >= g) continue;
            const float sc = dot[u][h] * kscl;
            if (c == 0) ss[h * kTile + r] = sc;
            mx[h] = fmaxf(mx[h], sc);
          }
        }
      }
    }
    for (int o = 16; o >= L; o >>= 1) {
#pragma unroll
      for (int h = 0; h < G; ++h)
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
    }
#pragma unroll
    for (int h = 0; h < G; ++h)
      if (lane == 0 && h < g) wm[warp * g + h] = mx[h];
    __syncthreads();  // scores and maxima visible

    // online softmax (every thread the same m) and P . V
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= g) continue;
      float tmax = wm[h];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tmax = fmaxf(tmax, wm[w * g + h]);
      const float m_new = fmaxf(m[h], tmax);
      const float alpha = exp2_fast(m[h] - m_new);
      m[h] = m_new;
      lsum[h] *= alpha;
#pragma unroll
      for (int e = 0; e < kVC; ++e) acc[h][e] *= alpha;
    }
    if (kp < KP) {
      for (int r = kp; r < nvalid; r += KP) {
        float vf[kVC];
        load_f32<T, kVC>(vt + r * d + tc * kVC, vf);
        const float vsc = kQ8 ? vst[r] : 1.f;
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (h >= g) continue;
          const float p = exp2_fast(ss[h * kTile + r] - m[h]);
          lsum[h] += p;
          const float pv = p * vsc;
#pragma unroll
          for (int e = 0; e < kVC; ++e) acc[h][e] = fmaf(pv, vf[e], acc[h][e]);
        }
      }
    }
  }

  // add the KP key groups' partial sums in a fixed order
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* racc = reinterpret_cast<float*>(smem);   // [KP, g, d]
  float* rl = racc + KP * g * d;                  // [KP, g]
  if (kp < KP) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= g) continue;
#pragma unroll
      for (int e = 0; e < kVC; ++e)
        racc[(kp * g + h) * d + tc * kVC + e] = acc[h][e];
      if (tc == 0) rl[kp * g + h] = lsum[h];
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h)
      if (h < g) mfin[h] = m[h];
  }
  __syncthreads();

  const size_t row0 = (size_t)b * n + (size_t)kvh * g;   // first head's row
  const size_t rows = (size_t)gridDim.z * n;
  for (int i = tid; i < g * d; i += kThreads) {
    const int h = i / d, col = i - h * d;
    float a = 0.f, l = 0.f;
    for (int k = 0; k < KP; ++k) {
      a += racc[(k * g + h) * d + col];
      l += rl[k * g + h];
    }
    if (S == 1) {
      // l == 0 only for an empty row, where a is 0 too
      out[(row0 + h) * d + col] = __float2bfloat16(l > 0.f ? a / l : 0.f);
    } else {
      const size_t at = (row0 + h) * S + split;
      part[at * d + col] = a;
      if (col == 0) {
        part[rows * S * d + at] = mfin[h];
        part[rows * S * d + rows * S + at] = l;
      }
    }
  }
}

// Merge the used splits of one (row, query head): m = max m_s,
// l = sum l_s * 2^(m_s - m), out = sum acc_s * 2^(m_s - m) / l, in split
// order.  T only names the kernel after its page type (a profile tells K1's
// combine from K4's by it).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const float* __restrict__ part,
                            const int* __restrict__ lens,
                            __nv_bfloat16* __restrict__ out, int n, int d,
                            int S, int split_tokens, int max_len) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t rows = (size_t)gridDim.y * n;
  const size_t bh = (size_t)b * n + h;
  const int len = min(lens[b], max_len);
  const int used = (len + split_tokens - 1) / split_tokens;
  const float* acc = part + bh * S * d;
  const float* mp = part + rows * S * d + bh * S;
  const float* lp = mp + rows * S;
  float mx = kNegInf;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, mp[s]);
  float l = 0.f;
  for (int s = 0; s < used; ++s) l += lp[s] * exp2_fast(mp[s] - mx);
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float o = 0.f;
    for (int s = 0; s < used; ++s) o += acc[(size_t)s * d + col] * exp2_fast(mp[s] - mx);
    out[bh * d + col] = __float2bfloat16(used > 0 ? o / l : 0.f);
  }
}

// Lift a kernel's dynamic shared-memory cap to `smem` on the current device,
// calling the runtime only when a larger size than before is asked for there
// (the call costs about as much as a launch).  One cache per instantiation.
template <typename T, int G>
cudaError_t raise_smem_cap(size_t smem) {
  constexpr int kMaxDevices = 64;
  static size_t cap[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= cap[dev]) return cudaSuccess;
  const void* fn = (const void*)paged_decode_split_kernel<T, G>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  // the whole unified L1 / shared array as shared memory, so that as many
  // blocks as the shared memory admits are resident on an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) cap[dev] = smem;
  return err;
}

template <typename T, int G>
int launch_group(const void* q, const void* kpool, const void* vpool,
                 const void* kscale, const void* vscale, const void* tables,
                 const void* lens, void* out, void* part, int B, int n,
                 int nkv, int d, int page, int pages_max, int splits,
                 int split_pages, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, G>(n / nkv, d, split_pages);
  cudaError_t err = raise_smem_cap<T, G>(smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_split_kernel<T, G><<<dim3(splits, nkv, B), kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const T*)kpool, (const T*)vpool,
      (const float*)kscale, (const float*)vscale, (const int*)tables,
      (const int*)lens, (__nv_bfloat16*)out, (float*)part, n, nkv, d, page,
      pages_max, split_pages, sm_scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  paged_decode_combine_kernel<T><<<dim3(n, B), kThreads, 0, stream>>>(
      (const float*)part, (const int*)lens, (__nv_bfloat16*)out, n, d, splits,
      split_pages * page, pages_max * page);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* kscale, const void* vscale, const void* tables,
           const void* lens, void* out, void* part, int B, int n, int nkv,
           int d, int page, int pages_max, int splits, int split_pages,
           float sm_scale, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  // the splits must cover the table, and S > 1 needs the partials
  if (splits < 1 || split_pages < 1 ||
      (long long)splits * split_pages < pages_max ||
      (long long)(splits - 1) * split_pages >= (pages_max > 0 ? pages_max : 1) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int g = n / nkv;
  cudaStream_t s = (cudaStream_t)stream;
#define PAGED_LAUNCH(G)                                                       \
  return launch_group<T, G>(q, kpool, vpool, kscale, vscale, tables, lens,    \
                            out, part, B, n, nkv, d, page, pages_max, splits, \
                            split_pages, sm_scale, s)
  if (g <= 1) PAGED_LAUNCH(1);
  if (g <= 2) PAGED_LAUNCH(2);
  if (g <= 4) PAGED_LAUNCH(4);
  if (g <= 8) PAGED_LAUNCH(8);
  PAGED_LAUNCH(16);
#undef PAGED_LAUNCH
}

template <typename T>
size_t smem_for(int g, int d, int split_pages) {
  if (g <= 1) return smem_bytes<T, 1>(g, d, split_pages);
  if (g <= 2) return smem_bytes<T, 2>(g, d, split_pages);
  if (g <= 4) return smem_bytes<T, 4>(g, d, split_pages);
  if (g <= 8) return smem_bytes<T, 8>(g, d, split_pages);
  return smem_bytes<T, 16>(g, d, split_pages);
}

}  // namespace

// q [B, n, d], kpool / vpool [num_pages, nkv, page, d] bf16, tables
// [B, pages_max] int32, lens [B] int32 -> out [B, n, d] bf16.  All
// contiguous.  The split plan: `splits` blocks a (row, kv head), each over
// `split_pages` pages (splits * split_pages covers pages_max, and no split
// starts past it); with splits > 1, `part` is an f32 workspace of
// B * n * splits * (d + 2) floats.  The caller checks n % nkv == 0,
// n / nkv <= 16, d % 8 == 0 and d <= 256.  Returns the launches'
// cudaError_t (0 on success).
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* kpool, const void* vpool, const void* tables,
    const void* lens, void* out, void* part, int B, int n, int nkv, int d,
    int page, int pages_max, int splits, int split_pages, float sm_scale,
    void* stream) {
  return launch<__nv_bfloat16>(q, kpool, vpool, nullptr, nullptr, tables,
                               lens, out, part, B, n, nkv, d, page, pages_max,
                               splits, split_pages, sm_scale, stream);
}

// As paged_decode_attention_bf16 over int8 pools, with kscale / vscale
// [num_pages, nkv, page] f32.  The caller checks d % 16 == 0 as well.
extern "C" int paged_decode_attention_q8(
    const void* q, const void* kpool, const void* vpool, const void* kscale,
    const void* vscale, const void* tables, const void* lens, void* out,
    void* part, int B, int n, int nkv, int d, int page, int pages_max,
    int splits, int split_pages, float sm_scale, void* stream) {
  return launch<int8_t>(q, kpool, vpool, kscale, vscale, tables, lens, out,
                        part, B, n, nkv, d, page, pages_max, splits,
                        split_pages, sm_scale, stream);
}

// Dynamic shared memory one split block of `split_pages` pages needs (int8
// pages when q8 != 0); the wrapper rejects shapes above the card's 227 KB per
// block.  It does not depend on the page size.
extern "C" long long paged_decode_attention_smem_bytes(int n, int nkv, int d,
                                                       int split_pages,
                                                       int q8) {
  return (long long)(q8 ? smem_for<int8_t>(n / nkv, d, split_pages)
                        : smem_for<__nv_bfloat16>(n / nkv, d, split_pages));
}
