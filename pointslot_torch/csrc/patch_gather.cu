// patch_gather.cu: batched 48x48 patch gather for the ORB / stereo frontend.
//
// Replaces the TPU kernel pointslot_tpu/ops/pallas_patch.py::_patch_kernel_stack
// (body at :100, pallas_call at :203). That kernel reads a canvas: the
// pyramid levels zero-padded onto level 0's (h + 64, w + 256) frame and
// stacked. It computes
//     out[k, i, j] = canvas[l_k, y_k + i, x_k + j]      for i, j < 48,
// with every index clamped the way JAX indexing clamps it: a negative index
// counts from the end of its axis, then the index is clipped to the axis.
//
// Here no canvas exists. The kernel takes the L planes where they lie (each
// with its own height, width and row pitch) and the canvas size (Hp, Wp),
// and computes the same thing: canvas pixel (l, r, c) is
// plane_l[r - 24, c - 24] inside the plane and 0 in the padding. The padding
// is written as zeros during the copy and never read.
//
// Multi-image form (the flat frontend, stack_pyramid_for_patches_multi at
// pallas_patch.py:45): each plane l holds G images, image g at
// ptr[l] + g * img_stride[l]. The canvas has G * L rows, image g's level l
// at row g * L + l; a patch's row is clamped to [0, G * L) and read from
// image row / L, level row % L. One image (G = 1) is the single-pair call;
// it launches the kernel's single-image instance, which has no division and
// reads no image stride, so its code is the earlier single-image kernel's.
// Run at G = 1, the multi-image body was slower than this instance on the
// H100 by more than the spread of repeats: warm at the four single-pair
// sites, L2-cold at the three with K = 1000. chip_smoke.py's phase 3 times
// the two bodies there in turns (PERF.md).
//
// Bound: bytes. A patch moves 9216 bytes out and at most as many in, with
// no arithmetic. The earlier design (one warp per patch, a chain of 72
// dependent scalar load-store round trips per lane) was bound by latency,
// not bytes: its time did not move with K. This design keeps every load of
// a patch in flight at once:
// - one 256-thread block per patch, whose tile (2304 floats, 9216 bytes)
//   lives in shared memory; 8 blocks fit an SM, so 1000 patches run in one
//   wave on 132 SMs;
// - each thread issues its 9 four-byte cp.async copies into the tile, the
//   zero-fill form (src-size 0) for padding pixels, then waits once;
// - one thread writes the tile to out[k] with one bulk asynchronous copy
//   (cp.async.bulk.global.shared::cta). Measured on the H100 against the
//   block writing the tile with 16-byte vector stores, the bulk copy was as
//   fast at K = 1000 and 7 % faster at K = 4000 (PERF.md).
//
// Why not TMA tile loads: cuTensorMapEncodeTiled needs row pitches that are
// multiples of 16 bytes. The KITTI level pitches (1242, 1035, 862, 719,
// 599, 499, 416, 347 floats) are not, but for 416, and re-pitching the
// pyramid's matmul outputs would reach into the pyramid and FAST code for a
// 9 KB tile. The canvas's own pitch (1498 floats) is not aligned either.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kPatch = 48;
constexpr int kPad = kPatch / 2;            // the canvas's top and left padding
constexpr int kTile = kPatch * kPatch;      // floats per patch
constexpr int kThreads = 256;
constexpr int kPerThread = kTile / kThreads;
constexpr int kMaxPlanes = 8;
static_assert(kTile % kThreads == 0, "a block copies whole tiles");
static_assert((kTile * 4) % 16 == 0, "bulk copies move multiples of 16 bytes");

struct Planes {
  const float* ptr[kMaxPlanes];       // image 0 of each level
  long long pitch[kMaxPlanes];        // row stride, floats
  long long img_stride[kMaxPlanes];   // image stride, floats
  int h[kMaxPlanes];
  int w[kMaxPlanes];
  int n;                              // L
  int rows;                           // G * L, the canvas's row count
  int Hp, Wp;                         // the canvas the planes stand for
};

__device__ __forceinline__ int clamp_index(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ void copy4_async(uint32_t dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

template <bool kMulti>
__global__ void __launch_bounds__(kThreads, 8)
patch_gather_kernel(const Planes p, const int* __restrict__ xyl, float* __restrict__ out) {
  __shared__ __align__(128) float tile[kTile];
  const int k = blockIdx.x;
  const int x = __ldg(xyl + 3 * k);
  const int y = __ldg(xyl + 3 * k + 1);
  const int row = clamp_index(__ldg(xyl + 3 * k + 2), p.rows);
  int l = row;
  const float* plane;
  if constexpr (kMulti) {
    const int g = row / p.n;
    l = row - g * p.n;
    plane = p.ptr[l] + g * p.img_stride[l];
  } else {
    plane = p.ptr[l];
  }
  const long long pitch = p.pitch[l];
  const unsigned h = p.h[l], w = p.w[l];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tile));

#pragma unroll
  for (int n = 0; n < kPerThread; ++n) {
    const int e = threadIdx.x + n * kThreads;
    const int i = e / kPatch;
    const int j = e - i * kPatch;
    const int r = clamp_index(y + i, p.Hp) - kPad;
    const int c = clamp_index(x + j, p.Wp) - kPad;
    const bool inside = static_cast<unsigned>(r) < h && static_cast<unsigned>(c) < w;
    const float* src = inside ? plane + r * pitch + c : plane;
    copy4_async(base + 4u * e, src, inside ? 4 : 0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the tile was written through the generic proxy; the bulk copy reads
  // it through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    float* dst = out + static_cast<size_t>(k) * kTile;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(dst), "r"(base), "r"(kTile * 4) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

}  // namespace

// planes/pitches/img_strides/heights/widths: L host arrays describing the
// planes (device pointers to image 0's float32 plane, row pitch and image
// stride in floats); G: images per plane; (Hp, Wp): the canvas size;
// xyl: (K, 3) int32 on the device (x, y, canvas row); out: (K, 48, 48)
// float32 on the device, 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (0 on success). K must be positive, 1 <= L <= 8, G >= 1.
extern "C" int patch_gather(const void* const* planes, const long long* pitches,
                            const long long* img_strides, const int* heights,
                            const int* widths, int L, int G, int Hp, int Wp,
                            const void* xyl, void* out, int K, void* stream) {
  if (L < 1 || L > kMaxPlanes || G < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Planes p{};
  for (int l = 0; l < L; ++l) {
    p.ptr[l] = static_cast<const float*>(planes[l]);
    p.pitch[l] = pitches[l];
    p.img_stride[l] = img_strides[l];
    p.h[l] = heights[l];
    p.w[l] = widths[l];
  }
  p.n = L;
  p.rows = G * L;
  p.Hp = Hp;
  p.Wp = Wp;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* idx = static_cast<const int*>(xyl);
  auto* dst = static_cast<float*>(out);
  if (G == 1)
    patch_gather_kernel<false><<<K, kThreads, 0, s>>>(p, idx, dst);
  else
    patch_gather_kernel<true><<<K, kThreads, 0, s>>>(p, idx, dst);
  return static_cast<int>(cudaGetLastError());
}
