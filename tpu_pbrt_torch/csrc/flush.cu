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
// 2 * F * 4L * 128 FP32 FLOP (FMA = 2) against ~F*4L*4 bytes of features,
// i.e. 128 FLOP per feature byte from device memory; the features of a
// block are read once from HBM/L2 and then served from shared memory. The
// contraction runs on FP32 FMAs (not TF32 tensor cores) because the
// reference contracts at Precision.HIGHEST; the FMA chain over f = 0..F-1
// sums in the feature order, and t agrees with the plain version (a full
// f32 product) to the 2 ulp its comparison allows.
//
// Design: one thread block per leaf block, 128 threads, one per ray slot.
// phi lives in registers; the treelet's columns stream through a shared
// tile of TK triangles (F x 4 x TK floats), loaded coalesced by all 128
// threads and read as warp-wide broadcasts. The TPU merge relied on the
// grid running in order; CUDA blocks do not, so the merge is a 64-bit
// atomicMin on a packed key per ray: the order-preserving bits of t in the
// high word, and in the low word 0 for the seeded t_in or b*128+slot+1 for
// a candidate of block b. A ray appears at most once per block, so this
// ranks ties exactly as "seed first, then lowest block" — the reference's
// strict < in grid order. The block also keeps each slot's local argmin in
// a (CH, 128) scratch; a last pass over the R rays decodes the winning key
// into (t, prim = meta[b,1] + argmin). Three launches per chunk: seed,
// blocks, finalize.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;  // ray slots per leaf block (= threads per block)
constexpr int TK = 32;      // triangles per shared-memory tile

// order-preserving f32 -> u32 map (total order for non-NaN values)
__device__ __forceinline__ uint32_t fkey(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float fkey_inv(uint32_t k) {
  uint32_t u = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
  return __uint_as_float(u);
}

__global__ void seed_kernel(const float* __restrict__ t_in,
                            unsigned long long* __restrict__ keys, int R) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R) keys[r] = (unsigned long long)fkey(t_in[r]) << 32;
}

template <int F>
__global__ void __launch_bounds__(BLOCK)
flush_blocks_kernel(const float* __restrict__ feat, const int* __restrict__ meta,
                    const int* __restrict__ rid, const float* __restrict__ rayF,
                    unsigned long long* __restrict__ keys, int* __restrict__ karg,
                    int L, int R, float neg_edge, float one_edge) {
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int* m = meta + (size_t)b * 8;
  if (m[5] == 0) return;  // dead block: uniform across the thread block

  const int r = rid[(size_t)b * BLOCK + s];
  int rc = r < 0 ? 0 : r;
  rc = rc < R ? rc : R - 1;
  const float cx = __int_as_float(m[2]);
  const float cy = __int_as_float(m[3]);
  const float cz = __int_as_float(m[4]);
  const float oc[3] = {__fsub_rn(rayF[rc], cx), __fsub_rn(rayF[(size_t)R + rc], cy),
                       __fsub_rn(rayF[2 * (size_t)R + rc], cz)};
  const float dc[3] = {rayF[3 * (size_t)R + rc], rayF[4 * (size_t)R + rc],
                       rayF[5 * (size_t)R + rc]};

  float phi[F];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) phi[3 * i + j] = __fmul_rn(oc[i], dc[j]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    phi[9 + i] = dc[i];
    phi[12 + i] = oc[i];
  }
  phi[15] = 1.0f;
  if (F == 64) {
    // cubic-in-time features: phi * [t, t*t, (t*t)*t], the reference's order
    const float tm = rayF[7 * (size_t)R + rc];
    const float tm2 = __fmul_rn(tm, tm);
    const float tm3 = __fmul_rn(tm2, tm);
#pragma unroll
    for (int f = 0; f < 16; ++f) {
      phi[16 + f] = __fmul_rn(phi[f], tm);
      phi[32 + f] = __fmul_rn(phi[f], tm2);
      phi[48 + f] = __fmul_rn(phi[f], tm3);
    }
  }

  __shared__ float tile[F][4][TK];
  const size_t fourL = 4 * (size_t)L;
  const float* fb = feat + (size_t)m[0] * F * fourL;
  float best = __int_as_float(0x7f800000);  // +inf
  int bk = 0;
  for (int k0 = 0; k0 < L; k0 += TK) {
    for (int i = s; i < F * 4 * TK; i += BLOCK) {
      const int f = i / (4 * TK);
      const int g = (i / TK) % 4;
      const int kk = i % TK;
      tile[f][g][kk] = (k0 + kk < L) ? fb[f * fourL + (size_t)g * L + k0 + kk] : 0.0f;
    }
    __syncthreads();
    const int kn = (L - k0) < TK ? (L - k0) : TK;
    for (int kk = 0; kk < kn; ++kk) {
      float det = 0.0f, ud = 0.0f, vd = 0.0f, td = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        det = __fmaf_rn(tile[f][0][kk], phi[f], det);
        ud = __fmaf_rn(tile[f][1][kk], phi[f], ud);
        vd = __fmaf_rn(tile[f][2][kk], phi[f], vd);
        td = __fmaf_rn(tile[f][3][kk], phi[f], td);
      }
      const float inv = __fdiv_rn(1.0f, det == 0.0f ? 1.0f : det);
      const float u = __fmul_rn(ud, inv);
      const float v = __fmul_rn(vd, inv);
      const float t = __fmul_rn(td, inv);
      const bool hit = (det != 0.0f) && (u >= neg_edge) && (v >= neg_edge) &&
                       (__fadd_rn(u, v) <= one_edge) && (t > 0.0f);
      // strict < keeps the lowest local index among equal t
      if (hit && t < best) {
        best = t;
        bk = k0 + kk;
      }
    }
    __syncthreads();
  }
  karg[(size_t)b * BLOCK + s] = bk;
  if (r >= 0 && best < __int_as_float(0x7f800000)) {
    const unsigned long long key =
        ((unsigned long long)fkey(best) << 32) | (unsigned long long)(b * BLOCK + s + 1);
    atomicMin(keys + r, key);
  }
}

__global__ void finalize_kernel(const unsigned long long* __restrict__ keys,
                                const float* __restrict__ t_in, const int* __restrict__ p_in,
                                const int* __restrict__ meta, const int* __restrict__ karg,
                                float* __restrict__ t_out, int* __restrict__ p_out, int R) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const unsigned long long key = keys[r];
  const uint32_t low = (uint32_t)(key & 0xffffffffu);
  if (low == 0) {
    t_out[r] = t_in[r];
    p_out[r] = p_in[r];
  } else {
    const int slot = (int)low - 1;
    const int b = slot / BLOCK;
    t_out[r] = fkey_inv((uint32_t)(key >> 32));
    p_out[r] = meta[(size_t)b * 8 + 1] + karg[slot];
  }
}

}  // namespace

extern "C" {

const char* flush_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// All pointers are device pointers; `stream` is the caller's cudaStream_t.
// keys: (R,) u64 scratch, karg: (CH, 128) i32 scratch. Returns cudaError_t.
int flush_chunk_launch(const float* feat, const int* meta, const int* rid, const float* rayF,
                       const float* t_in, const int* p_in, float* t_out, int* p_out,
                       unsigned long long* keys, int* karg, int CH, int F, int L, int R,
                       float neg_edge, float one_edge, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const int rblocks = (R + threads - 1) / threads;
  seed_kernel<<<rblocks, threads, 0, st>>>(t_in, keys, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (CH > 0) {
    if (F == 16) {
      flush_blocks_kernel<16><<<CH, BLOCK, 0, st>>>(feat, meta, rid, rayF, keys, karg, L, R,
                                                    neg_edge, one_edge);
    } else if (F == 64) {
      flush_blocks_kernel<64><<<CH, BLOCK, 0, st>>>(feat, meta, rid, rayF, keys, karg, L, R,
                                                    neg_edge, one_edge);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  finalize_kernel<<<rblocks, threads, 0, st>>>(keys, t_in, p_in, meta, karg, t_out, p_out, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
