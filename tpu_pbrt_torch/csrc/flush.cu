// Stream-tracer FLUSH chunk: leaf-block triangle tests + per-ray closest-hit merge.
//
// Replaces the TPU kernel tpu_pbrt/accel/fusedwave.py::fused_flush_chunk
// (pallas_call at fusedwave.py:247, grid body _flush_kernel at :112, seed
// _seed_accumulators at :103).
//
// What it computes, per chunk of CH leaf blocks (one treelet x <= 128 ray
// slots, -1 = empty slot, block skipped when meta[b,5] == 0): gather each
// slot's ray from the lane-major (8, R) table rayF [o | d | t | time],
// re-center its origin on the treelet center (f32 bits in meta[b,2:5]),
// build the F-row feature phi (o(x)d, d, o, 1; times [1, t, t^2, t^3] when
// F == 64), contract it with the treelet's (F, 4L) feature block, decode
// det/u/v/t with the EDGE_EPS band and t > 0, keep the min t with the
// lowest local index, and fold the winner into the (R,) (t, prim) state
// exactly as the reference's sequential strict-< merge in block order.
//
// What bounds it on the H100: operations. Each live block does
// 2 * F * 4L * 128 FP32 FLOP (FMA = 2) against F*4L*4 bytes of features.
// The contraction runs on FP32 FMAs (not TF32 tensor cores) because the
// reference contracts at Precision.HIGHEST: every output (ray, triangle,
// component) is one FMA chain over f = 0..F-1 in order, starting from 0,
// so t is bit-for-bit what a one-thread-per-ray loop gives.
//
// Design, against the FP32 pipes (SPLIT thread blocks of WARPS warps per
// leaf block):
// - Register tiling. A warp covers all 128 ray slots, RT = 4 per lane
//   (slots 4*lane .. 4*lane + 3). The slots' base features sit in shared
//   memory as [feature][slot], one float4 per feature per lane. The
//   triangle features sit in shared memory in the global layout [f][g][k]
//   (g = det, u, v, t rows), so one broadcast float4 load gives 4
//   consecutive triangles of one (f, g) and feeds 4 triangles x 4 rays =
//   16 FMAs. A lane keeps a 4 rays x 4 triangles x 4 components tile of
//   accumulators (64 independent chains). F == 64 scales the 16 base
//   features by t, t^2, t^3 on the fly: the reference's phi products.
// - Split the triangles, not the FMA chain. The SPLIT * WARPS warps of a
//   leaf block take the treelet's TT-triangle tiles in turn, so the zero
//   padding of a partly filled treelet spreads over all of them. A warp
//   walks its tiles in ascending order with strict <; a thread block folds
//   its warps by the lexicographic minimum of (t, local index).
// - Padding costs nothing: a group of 4 triangles whose det features are
//   all +-0 has det == 0 for every ray and never hits; it is skipped.
// - Asynchronous loads. Each warp streams its tiles through an NSTAGE-deep
//   ring with 16-byte cp.async copies (zero fill past L), so the next
//   tiles load while the current one computes; no index arithmetic is
//   left in the inner loop. The ring, the slots' features and the fold
//   buffers take dynamic shared memory (65 KB at F = 16, two blocks per
//   SM; 209 KB at F = 64, one).
// - Exact decode. Every (ray, triangle) pair of a live group is decoded as
//   the reference divides: __frcp_rn (correctly rounded, the same bits as
//   1.0f / det), no fast math, no flush to 0.
// - Merge across blocks (design (a)): CUDA blocks run in no order, so each
//   thread block's per-slot winner does a 64-bit atomicMin on a packed key
//   per ray: the order-preserving bits of t in the high word, and in the
//   low word 0 for the seeded t_in or b*L + k + 1 for local triangle k of
//   leaf block b. Ties therefore rank "seed first, then lowest block, then
//   lowest local index" however the triangles were split — the
//   reference's strict < in grid order over its argmin. A last pass over
//   the R rays decodes the winning key into (t, prim = meta[b,1] + k).
//   Three launches per chunk: seed, blocks, finalize.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BLOCK = 128;  // ray slots per leaf block
constexpr int RT = 4;       // ray slots per lane (32 lanes x RT = BLOCK)
constexpr int TT = 8;       // triangles per pipeline tile
constexpr int NSTAGE = 3;   // tiles in flight per warp
constexpr int WARPS = 8;    // warps per thread block
constexpr int SPLIT = 2;    // thread blocks per leaf block

// order-preserving f32 -> u32 map (total order for non-NaN values)
__device__ __forceinline__ uint32_t fkey(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float fkey_inv(uint32_t k) {
  uint32_t u = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(u);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int F>
struct Smem {
  static constexpr int kTile = F * 4 * TT;              // floats per tile
  static constexpr int kRing = WARPS * NSTAGE * kTile;  // floats
  static constexpr int kPhi = 17 * BLOCK;               // base features + time
  static constexpr int kFold = 2 * WARPS * BLOCK;       // (t, k) per warp
  static constexpr int kBytes = (kRing + kPhi + kFold) * 4;
};

__global__ void seed_kernel(const float* __restrict__ t_in,
                            unsigned long long* __restrict__ keys, int R) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R) keys[r] = (unsigned long long)fkey(t_in[r]) << 32;
}

// One warp's tile: TT triangles from t0 of all F x 4 rows into `dst`
// ([row][TT]); 16-byte copies, zero fill from L on.
template <int F>
__device__ __forceinline__ void load_tile(float* dst, const float* fb, int L, int t0, int lane) {
  constexpr int Q = TT / 4;  // 16-byte chunks per row
  static_assert(F * 4 * Q % 32 == 0, "whole copies per lane");
#pragma unroll
  for (int it = 0; it < F * 4 * Q / 32; ++it) {
    const int c = lane + 32 * it;
    const int row = c / Q;
    const int q = c % Q;
    const int k = t0 + 4 * q;
    const bool ok = k < L;
    cp_async16(dst + row * TT + 4 * q, ok ? fb + (size_t)row * L + k : fb, ok ? 16 : 0);
  }
}

// Bit q is set when some triangle of the tile's float4 group q has a
// nonzero det feature. A triangle whose det features are all +-0 (the
// zero padding of a treelet that holds fewer than L triangles) has
// det == 0 (or NaN) for every ray and can never hit.
template <int F>
__device__ __forceinline__ uint32_t live_groups(const float* tile, int lane) {
  constexpr int Q = TT / 4;
  static_assert(32 % Q == 0 && F * Q % 32 == 0, "lanes tile the det rows");
  uint32_t bits = 0;
#pragma unroll
  for (int it = 0; it < F * Q / 32; ++it) {
    const int c = lane + 32 * it;  // det row of feature c / Q, group c % Q
    const uint4 x = *reinterpret_cast<const uint4*>(tile + (c / Q) * 4 * TT + 4 * (c % Q));
    bits |= x.x | x.y | x.z | x.w;
  }
  const uint32_t ball = __ballot_sync(0xffffffffu, (bits & 0x7fffffffu) != 0);
  uint32_t groups = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    uint32_t lanes_q = 0;  // the lanes that read group q
#pragma unroll
    for (int l = q; l < 32; l += Q) lanes_q |= 1u << l;
    groups |= (uint32_t)((ball & lanes_q) != 0) << q;
  }
  return groups;
}

// acc[r][kk][g] (+)= sum over the 16 features j of tile row (j, g)[kk] *
// phi_j of slot 4*lane + r, in feature order, one FMA per step. SCALE
// multiplies the base features by sc (F == 64: the chunk's time power).
template <bool SCALE>
__device__ __forceinline__ void contract16(float (&acc)[RT][4][4], const float* tc,
                                           const float4* phi4, const float (&sc)[RT]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float4 pv = phi4[j * BLOCK / 4];
    float p[RT] = {pv.x, pv.y, pv.z, pv.w};
    if (SCALE) {
#pragma unroll
      for (int r = 0; r < RT; ++r) p[r] = __fmul_rn(p[r], sc[r]);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 wv = *reinterpret_cast<const float4*>(tc + (j * 4 + g) * TT);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        acc[r][0][g] = __fmaf_rn(wv.x, p[r], acc[r][0][g]);
        acc[r][1][g] = __fmaf_rn(wv.y, p[r], acc[r][1][g]);
        acc[r][2][g] = __fmaf_rn(wv.z, p[r], acc[r][2][g]);
        acc[r][3][g] = __fmaf_rn(wv.w, p[r], acc[r][3][g]);
      }
    }
  }
}

// Moller-Trumbore decode of one (ray, triangle) pair from its four FMA
// chains, folded into the ray's running best with strict < (triangles come
// in ascending local order, so the lowest index wins among equal t).
__device__ __forceinline__ void decode(const float (&o)[4], int k, float neg_edge,
                                       float one_edge, float& best, int& bk) {
  const float det = o[0];
  const float inv = __frcp_rn(det == 0.0f ? 1.0f : det);
  const float u = __fmul_rn(o[1], inv);
  const float v = __fmul_rn(o[2], inv);
  const float t = __fmul_rn(o[3], inv);
  const bool hit = (det != 0.0f) && (u >= neg_edge) && (v >= neg_edge) &&
                   (__fadd_rn(u, v) <= one_edge) && (t > 0.0f);
  if (hit && t < best) {
    best = t;
    bk = k;
  }
}

// two thread blocks per SM at F == 16 (registers <= 128); one at F == 64,
// whose tile ring takes most of the shared memory
template <int F>
__global__ void __launch_bounds__(WARPS * 32, F == 16 ? 2 : 1)
flush_blocks_kernel(const float* __restrict__ feat, const int* __restrict__ meta,
                    const int* __restrict__ rid, const float* __restrict__ rayF,
                    unsigned long long* __restrict__ keys, int L, int R, float neg_edge,
                    float one_edge) {
  const int b = blockIdx.x;
  const int* m = meta + (size_t)b * 8;
  if (m[5] == 0) return;  // dead block: uniform across the thread block

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  float* ring = smem + w * NSTAGE * Smem<F>::kTile;
  float* phis = smem + Smem<F>::kRing;  // [16 base features + time][slot]
  float* fold_t = phis + Smem<F>::kPhi;
  int* fold_k = reinterpret_cast<int*>(fold_t + WARPS * BLOCK);

  // this warp's tiles: the block's SPLIT * WARPS warps take the treelet's
  // tiles in turn, starting from tile sw
  constexpr int NW = SPLIT * WARPS;
  const int sw = blockIdx.y * WARPS + w;
  const int ntile = ((L + TT - 1) / TT - sw + NW - 1) / NW;
  const float* fb = feat + (size_t)m[0] * F * 4 * L;
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < ntile) load_tile<F>(ring + i * Smem<F>::kTile, fb, L, (sw + i * NW) * TT, lane);
    cp_async_commit();
  }

  // gather the block's rays once and build each slot's 16 base features
  // (reference row order: o(x)d, d, o, 1) and its time
  int r_slot = -1;
  if (tid < BLOCK) {
    r_slot = rid[(size_t)b * BLOCK + tid];
    int rc = r_slot < 0 ? 0 : r_slot;
    rc = rc < R ? rc : R - 1;
    float oc[3], dc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      oc[i] = __fsub_rn(rayF[i * (size_t)R + rc], __int_as_float(m[2 + i]));
      dc[i] = rayF[(3 + i) * (size_t)R + rc];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) phis[(3 * i + j) * BLOCK + tid] = __fmul_rn(oc[i], dc[j]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      phis[(9 + i) * BLOCK + tid] = dc[i];
      phis[(12 + i) * BLOCK + tid] = oc[i];
    }
    phis[15 * BLOCK + tid] = 1.0f;
    phis[16 * BLOCK + tid] = F == 64 ? rayF[7 * (size_t)R + rc] : 0.0f;
  }
  __syncthreads();
  // this lane's RT slots are 4*lane .. 4*lane + 3: one float4 per feature
  const float4* phi4 = reinterpret_cast<const float4*>(phis) + lane;
  const float4 tm4 = phi4[16 * BLOCK / 4];
  const float tm[RT] = {tm4.x, tm4.y, tm4.z, tm4.w};
  const float one[RT] = {1.0f, 1.0f, 1.0f, 1.0f};

  float best[RT];
  int bk[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    best[r] = __int_as_float(0x7f800000);  // +inf
    bk[r] = 0;
  }

  for (int i = 0; i < ntile; ++i) {
    cp_async_wait<NSTAGE - 2>();
    __syncwarp();  // tile i is in; every lane is done with tile i - 1
    if (i + NSTAGE - 1 < ntile)
      load_tile<F>(ring + ((i + NSTAGE - 1) % NSTAGE) * Smem<F>::kTile, fb, L,
                   (sw + (i + NSTAGE - 1) * NW) * TT, lane);
    cp_async_commit();
    const float* tile = ring + (i % NSTAGE) * Smem<F>::kTile;
    const int t0 = (sw + i * NW) * TT;
    const uint32_t groups = live_groups<F>(tile, lane);
#pragma unroll 1
    for (int q = 0; q < TT / 4; ++q) {
      if (!(groups >> q & 1u)) continue;  // warp-uniform: four padding triangles
      float acc[RT][4][4];                // [ray][triangle][det, u, v, t]
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[r][kk][g] = 0.0f;
      contract16<false>(acc, tile + 4 * q, phi4, one);
      if (F == 64) {
        // t -> t*t -> (t*t)*t: the reference's phi * [t, t^2, t^3]
        float sc[RT] = {tm[0], tm[1], tm[2], tm[3]};
#pragma unroll 1
        for (int c = 1; c < F / 16; ++c) {
          contract16<true>(acc, tile + c * 16 * 4 * TT + 4 * q, phi4, sc);
#pragma unroll
          for (int r = 0; r < RT; ++r) sc[r] = __fmul_rn(sc[r], tm[r]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < RT; ++r)
          decode(acc[r][kk], t0 + 4 * q + kk, neg_edge, one_edge, best[r], bk[r]);
    }
  }
  cp_async_wait<0>();

  // fold the warps: lexicographic min of (t, local index), then merge
  reinterpret_cast<float4*>(fold_t + w * BLOCK)[lane] =
      make_float4(best[0], best[1], best[2], best[3]);
  reinterpret_cast<int4*>(fold_k + w * BLOCK)[lane] = make_int4(bk[0], bk[1], bk[2], bk[3]);
  __syncthreads();
  if (tid < BLOCK) {
    float bt = fold_t[tid];
    int bkk = fold_k[tid];
#pragma unroll
    for (int v = 1; v < WARPS; ++v) {
      const float tv = fold_t[v * BLOCK + tid];
      const int kv = fold_k[v * BLOCK + tid];
      if (tv < bt || (tv == bt && kv < bkk)) {
        bt = tv;
        bkk = kv;
      }
    }
    if (r_slot >= 0 && bt < __int_as_float(0x7f800000)) {
      const unsigned low = (unsigned)b * (unsigned)L + (unsigned)bkk + 1u;
      atomicMin(keys + r_slot, ((unsigned long long)fkey(bt) << 32) | low);
    }
  }
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ keys,
                                const float* __restrict__ t_in, const int* __restrict__ p_in,
                                const int* __restrict__ meta, float* __restrict__ t_out,
                                int* __restrict__ p_out, int L, int R) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const unsigned long long key = keys[r];
  const uint32_t low = (uint32_t)(key & 0xffffffffu);
  if (low == 0) {
    t_out[r] = t_in[r];
    p_out[r] = p_in[r];
  } else {
    const uint32_t b = (low - 1) / (uint32_t)L;  // low = b * L + k + 1
    t_out[r] = fkey_inv((uint32_t)(key >> 32));
    p_out[r] = meta[(size_t)b * 8 + 1] + (int)(low - 1 - b * (uint32_t)L);
  }
}

template <int F>
cudaError_t launch_blocks(const float* feat, const int* meta, const int* rid, const float* rayF,
                          unsigned long long* keys, int CH, int L, int R,
                          float neg_edge, float one_edge, cudaStream_t st) {
  // the dynamic shared memory cap is a per-device attribute: set it once
  // per device and kernel (setting it twice is harmless)
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev < kMaxDevices && attr_set[dev].load(std::memory_order_acquire);
  if (!known) {
    err = cudaFuncSetAttribute(flush_blocks_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<F>::kBytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) attr_set[dev].store(true, std::memory_order_release);
  }
  flush_blocks_kernel<F><<<dim3(CH, SPLIT), WARPS * 32, Smem<F>::kBytes, st>>>(
      feat, meta, rid, rayF, keys, L, R, neg_edge, one_edge);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flush_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// All pointers are device pointers; `stream` is the caller's cudaStream_t.
// L must be a multiple of 4 (16-byte rows) and CH * L < 2^32 - 1 (the
// key's low word). keys: (R,) u64 scratch. Returns cudaError_t.
int flush_chunk_launch(const float* feat, const int* meta, const int* rid, const float* rayF,
                       const float* t_in, const int* p_in, float* t_out, int* p_out,
                       unsigned long long* keys, int CH, int F, int L, int R, float neg_edge,
                       float one_edge, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (L <= 0 || L % 4 != 0 || (unsigned long long)CH * L >= 0xffffffffull)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int rblocks = (R + threads - 1) / threads;
  seed_kernel<<<rblocks, threads, 0, st>>>(t_in, keys, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (CH > 0) {
    if (F == 16) {
      err = launch_blocks<16>(feat, meta, rid, rayF, keys, CH, L, R, neg_edge, one_edge, st);
    } else if (F == 64) {
      err = launch_blocks<64>(feat, meta, rid, rayF, keys, CH, L, R, neg_edge, one_edge, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  finalize_kernel<<<rblocks, threads, 0, st>>>(keys, t_in, p_in, meta, t_out, p_out, L, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
