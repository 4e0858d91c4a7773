// Stream-tracer EXPAND: per popped (ray, node) pair, the 8-child slab tests
// and the packed push keys.
//
// Replaces the TPU kernel tpu_pbrt/accel/fusedwave.py::fused_expand
// (pallas_call at fusedwave.py:392, grid body _expand_kernel at :267).
//
// What it computes, for S popped pairs (packed key, node): decode the ray
// id = (key - 2^30) >> tb and a conservative entry distance from the low
// tb key bits (mantissa tail zero-filled); cull the pair when that
// distance exceeds the ray's current t (and, in any-hit mode, when the ray
// already has a hit); fetch the ray's (o, inv_d, t) from the lane-major
// (8, R) table rayE and the node's 8 child boxes and codes; slab-test all
// 8 children (the reference's _BOX_EPS widening and NaN rules); emit per
// child a packed push key (leaf: ray id; interior: 2^30 + (ray << tb) +
// ~quant(t_near), the quantization a LOGICAL shift of the f32 bits; dead:
// INT32_MAX), a candidate code (treelet id for leaves, node id for
// interiors) and the pair's live flag.
//
// What bounds it on the H100: bytes. Per pair it reads the key and node
// (8 B), 7 floats of its ray row (28 B), 48 box floats + 8 codes of its
// node (224 B, mostly L2 hits: the top tree is small) and writes 8 keys,
// 8 codes and a flag (68 B); a few hundred FLOP per pair is far below the
// card's compute rate.
//
// Design: one thread per pair, plain gathers from the node table (the
// TPU kernel's one-hot matmul was a gather workaround; on the CPU
// reference it is exact, so a gather from the same — clamped — table gives
// the same bits). Outputs are (8, S) child-major, so each of the 16 stores
// per thread is coalesced across the warp, and the caller's stable sort
// sees candidates in the reference's (child, pair) order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int I32_MAX = 0x7fffffff;
constexpr int EMPTY = 1 << 30;
constexpr int LEAF_STRIDE = 5;  // MAX_LEAF_PRIMS + 1 of the wide-leaf encoding

__device__ __forceinline__ float fmax_(float a, float b) { return a < b ? b : a; }
__device__ __forceinline__ float fmin_(float a, float b) { return b < a ? b : a; }

__device__ __forceinline__ void slab(float lo, float hi, float o, float inv, float box_eps,
                                     float& t0, float& t1) {
  const bool neg = inv < 0.0f;
  const float l = neg ? hi : lo;
  const float h = neg ? lo : hi;
  t0 = __fmul_rn(__fsub_rn(l, o), inv);
  t1 = __fmul_rn(__fmul_rn(__fsub_rn(h, o), inv), box_eps);
  if (isnan(t0)) t0 = -__int_as_float(0x7f800000);
  if (isnan(t1)) t1 = __int_as_float(0x7f800000);
}

__global__ void expand_kernel(const int* __restrict__ key_in, const int* __restrict__ node,
                              const float* __restrict__ rayE, const int* __restrict__ prim,
                              const float* __restrict__ box48, const int* __restrict__ cid,
                              int* __restrict__ key8, int* __restrict__ cand8,
                              int* __restrict__ live_out, int S, int R, int N, int tb,
                              int any_hit, float box_eps) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int key = key_in[s];
  int nd = node[s];
  nd = nd < 0 ? 0 : (nd < N ? nd : N - 1);
  int rid = (key - (1 << 30)) >> tb;
  rid = rid < 0 ? 0 : (rid < R ? rid : R - 1);
  float tn_in = 0.0f;
  if (tb) {
    const int comp = (key - (1 << 30)) & ((1 << tb) - 1);
    tn_in = __int_as_float(((1 << tb) - 1 - comp) << (31 - tb));
  }
  if (key == I32_MAX) tn_in = __int_as_float(0x7f800000);
  const float t_r = rayE[6 * (size_t)R + rid];
  bool live = (key != I32_MAX) && (tn_in <= t_r);
  if (any_hit) live = live && (prim[rid] < 0);

  float o[3], inv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = rayE[(size_t)i * R + rid];
    inv[i] = rayE[(size_t)(3 + i) * R + rid];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float t0[3], t1[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float lo = box48[(size_t)(a * 8 + c) * N + nd];
      const float hi = box48[(size_t)((3 + a) * 8 + c) * N + nd];
      slab(lo, hi, o[a], inv[a], box_eps, t0[a], t1[a]);
    }
    const float tn8 = fmax_(fmax_(t0[0], t0[1]), fmax_(t0[2], 0.0f));
    const float tf8 = fmin_(fmin_(t1[0], t1[1]), fmin_(t1[2], t_r));
    const int code = cid[(size_t)c * N + nd];
    const bool hit8 = live && (tn8 <= tf8) && (code != EMPTY);
    const bool is_int = hit8 && code >= 0;
    const bool is_leaf = hit8 && code < 0;
    const int qtn = tb ? (int)(__float_as_uint(tn8) >> (31 - tb)) : 0;
    const int key_int = (1 << 30) + (rid << tb) + (((1 << tb) - 1) - qtn);
    key8[(size_t)c * S + s] = is_leaf ? rid : (is_int ? key_int : I32_MAX);
    cand8[(size_t)c * S + s] = is_leaf ? (-(code + 1)) / LEAF_STRIDE : code;
  }
  live_out[s] = live ? 1 : 0;
}

}  // namespace

extern "C" {

const char* expand_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// All pointers are device pointers; `stream` is the caller's cudaStream_t.
// prim is read only when any_hit != 0. Returns cudaError_t.
int expand_launch(const int* key_in, const int* node, const float* rayE, const int* prim,
                  const float* box48, const int* cid, int* key8, int* cand8, int* live_out,
                  int S, int R, int N, int tb, int any_hit, float box_eps, void* stream) {
  if (S <= 0) return 0;
  const int threads = 256;
  expand_kernel<<<(S + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      key_in, node, rayE, prim, box48, cid, key8, cand8, live_out, S, R, N, tb, any_hit,
      box_eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
