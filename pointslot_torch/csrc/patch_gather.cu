// patch_gather.cu: batched 48x48 patch gather for the ORB / stereo frontend.
//
// Replaces the TPU kernel pointslot_tpu/ops/pallas_patch.py::_patch_kernel_stack
// (body at :100, pallas_call at :203). It computes
//     out[k, i, j] = canvas[l_k, y_k + i, x_k + j]      for i, j < 48,
// with every index clamped the way JAX indexing clamps it: a negative index
// counts from the end of its axis, then the index is clipped to the axis.
//
// The TPU kernel DMAs an aligned (56 or 64) x 256 superset per patch and cuts
// the window out with two one-hot shift matmuls, because Mosaic DMAs must be
// tile-aligned. None of that applies on Hopper. Here one warp copies one
// patch: its lanes walk the 2304 output floats in order, so every store is
// coalesced and the loads of a warp cover whole 48-float canvas rows. A block
// holds 8 warps (8 patches); there is no chunking and no shared memory.
//
// Bound: bytes. For K patches the kernel writes K * 48 * 48 * 4 bytes and reads
// at most as many canvas bytes (fewer where patches overlap), plus 12 bytes of
// coordinates per patch: at K = 1000 about 18.4 MB, about 5.5 us at the H100's
// 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kPatch = 48;
constexpr int kWarpsPerBlock = 8;  // one patch per warp

__device__ __forceinline__ int clamp_index(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
patch_gather_kernel(const float* __restrict__ canvas, const int* __restrict__ xyl,
                    float* __restrict__ out, int K, int L, int Hp, int Wp) {
  const int k = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (k >= K) return;
  const int lane = threadIdx.x % 32;
  const int x = xyl[3 * k];
  const int y = xyl[3 * k + 1];
  const int l = clamp_index(xyl[3 * k + 2], L);
  const float* plane = canvas + static_cast<size_t>(l) * Hp * Wp;
  float* dst = out + static_cast<size_t>(k) * kPatch * kPatch;
  for (int e = lane; e < kPatch * kPatch; e += 32) {
    const int i = e / kPatch;
    const int j = e - i * kPatch;
    const int r = clamp_index(y + i, Hp);
    const int c = clamp_index(x + j, Wp);
    dst[e] = __ldg(plane + static_cast<size_t>(r) * Wp + c);
  }
}

}  // namespace

// canvas: (L, Hp, Wp) float32, xyl: (K, 3) int32 (x, y, level), out: (K, 48, 48)
// float32; all contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() (0 on success). K must be positive.
extern "C" int patch_gather(const void* canvas, const void* xyl, void* out,
                            int K, int L, int Hp, int Wp, void* stream) {
  const int blocks = (K + kWarpsPerBlock - 1) / kWarpsPerBlock;
  patch_gather_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(canvas), static_cast<const int*>(xyl),
      static_cast<float*>(out), K, L, Hp, Wp);
  return static_cast<int>(cudaGetLastError());
}
