// Fused gaborish + EPF loop-filter chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel libjxl_tpu/ops/epf_pallas.py
// (apply_loop_filters_pallas, kernel body _build_kernel.kernel) and
// computes what its reference libjxl_tpu/ops/filters_tpu.py computes:
// gaborish 3x3, then EPF pass 0 (12 candidates, plus-shaped SAD),
// pass 1 (4 cross candidates, plus SAD), pass 2 (4 cross candidates,
// single-pixel SAD), with the stages chosen by `gab` and `epf_iters`.
//
// Design. One thread block owns one TILE x TILE output tile of one
// frame of a batch (blockIdx.z; a batch is one launch, as the
// reference's vmap is one dispatch, and frames may share one block map
// or have one each). It loads
// its input region, the tile plus a HALO = 1 + 3 + 2 + 1 = 7 pixel
// border, for all three channels into shared memory, reading mirrored
// coordinates at the frame edge (symmetric extension, the edge pixel
// repeats), so no padded copy of the frame is materialised. The enabled
// stages then run in place in shared memory, ping-ponging between two
// buffers, each stage shrinking the valid region by its reach (gaborish
// 1, pass 0 3, pass 1 2, pass 2 1). Sigma and the skip flag come per
// pixel from the (ceil(H/8), ceil(W/8)) block map at the mirrored
// coordinate, with the SAD multiplier raised on the first and last row
// and column of each 8x8 block, so the two full-resolution planes that
// the TPU kernel reads are never built. Mirroring commutes with every
// stage (stencils and candidate sets are symmetric), so halo pixels
// equal what the whole-frame formulation would produce after its own
// re-padding.
//
// Bound. The frame is read once and written once: at 3840x2160 that is
// 2 x 3 x 8,294,400 x 4 B = 199 MB plus the 0.5 MB block map, against
// the card's memory rate. The arithmetic is about 520 FP32 operations
// per pixel when each candidate's difference field is shared across the
// five plus taps; this first kernel recomputes the field per tap (about
// 1,200 operations per pixel) and does no FMA contraction (-fmad=false)
// so that it rounds like the plain PyTorch version it is held against.
// Making it fast (shared difference fields, fewer shared-memory reads,
// more blocks per SM) is later work.

#include <cuda_runtime.h>

#define TILE 32
#define HALO 7
#define REG (TILE + 2 * HALO)
#define PLANE (REG * REG)
#define THREADS 256

struct EpfParams {
  int h, w, bw;
  long long map_stride;    // floats between the frames' block maps (0: shared)
  int gab, epf_iters;
  float gw[3][3];          // normalised gaborish (w0, w1, w2) per channel
  float ch_scale[3];       // EPF channel scales
  float mul_in[3];         // per pass: sigma multiplier inside a block
  float mul_border[3];     // per pass: on the block's edge rows/columns
  float min_sigma;
};

__constant__ int2 kEpf0[12] = {{-2, 0}, {-1, -1}, {-1, 0}, {-1, 1},
                               {0, -2}, {0, -1},  {0, 1},  {0, 2},
                               {1, -1}, {1, 0},   {1, 1},  {2, 0}};
__constant__ int2 kCross[4] = {{-1, 0}, {0, -1}, {0, 1}, {1, 0}};
__constant__ int2 kPlus[5] = {{0, 0}, {-1, 0}, {0, -1}, {1, 0}, {0, 1}};

// Symmetric extension of an axis of length n ('abc' -> 'cba|abc|cba').
__device__ __forceinline__ int mirror(int i, int n) {
  const int p = 2 * n;
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - 1 - i;
}

__device__ __forceinline__ float chan_sad(const float* s, int a, int b,
                                          const EpfParams& p) {
  // ((0 + d0) + d1) + d2, in the reference's channel order.
  float d = fabsf(s[a] - s[b]) * p.ch_scale[0];
  d = d + fabsf(s[PLANE + a] - s[PLANE + b]) * p.ch_scale[1];
  d = d + fabsf(s[2 * PLANE + a] - s[2 * PLANE + b]) * p.ch_scale[2];
  return d;
}

// Gaborish from src into dst over the square [m, REG - m).
__device__ void gaborish_stage(const float* src, float* dst, int m,
                               const EpfParams& p) {
  const int n = REG - 2 * m;
  for (int i = threadIdx.x; i < 3 * n * n; i += blockDim.x) {
    const int c = i / (n * n);
    const int r = i - c * n * n;
    const int y = m + r / n, x = m + r % n;
    const float* s = src + c * PLANE + y * REG + x;
    const float w0 = p.gw[c][0], w1 = p.gw[c][1], w2 = p.gw[c][2];
    dst[c * PLANE + y * REG + x] =
        s[0] * w0 + (s[-1] + s[1] + s[-REG] + s[REG]) * w1 +
        (s[-REG - 1] + s[-REG + 1] + s[REG - 1] + s[REG + 1]) * w2;
  }
}

// One EPF pass from src into dst over the square [m, REG - m).
template <int NC, bool PLUS>
__device__ void epf_stage(const float* src, float* dst, int m,
                          const int2* cands, float mul_in,
                          float mul_border, const float* __restrict__ blocks,
                          int y0, int x0, const EpfParams& p) {
  const int n = REG - 2 * m;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int y = m + i / n, x = m + i % n;
    const int o = y * REG + x;
    const int my = mirror(y0 + y, p.h), mx = mirror(x0 + x, p.w);
    const float sig = __ldg(blocks + (my >> 3) * p.bw + (mx >> 3));
    if (sig < p.min_sigma) {
      dst[o] = src[o];
      dst[PLANE + o] = src[PLANE + o];
      dst[2 * PLANE + o] = src[2 * PLANE + o];
      continue;
    }
    const int ry = my & 7, rx = mx & 7;
    const bool border = ry == 0 || ry == 7 || rx == 0 || rx == 7;
    const float inv_sigma = sig * (border ? mul_border : mul_in);
    float a0 = src[o], a1 = src[PLANE + o], a2 = src[2 * PLANE + o];
    float wsum = 1.0f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int co = cands[k].x * REG + cands[k].y;
      float sad;
      if (PLUS) {
        sad = chan_sad(src, o + kPlus[0].x * REG + kPlus[0].y,
                       o + kPlus[0].x * REG + kPlus[0].y + co, p);
#pragma unroll
        for (int q = 1; q < 5; ++q) {
          const int t = o + kPlus[q].x * REG + kPlus[q].y;
          sad = sad + chan_sad(src, t, t + co, p);
        }
      } else {
        sad = chan_sad(src, o + co, o, p);
      }
      const float wgt = fmaxf(sad * inv_sigma + 1.0f, 0.0f);
      a0 = a0 + wgt * src[o + co];
      a1 = a1 + wgt * src[PLANE + o + co];
      a2 = a2 + wgt * src[2 * PLANE + o + co];
      wsum = wsum + wgt;
    }
    dst[o] = a0 / wsum;
    dst[PLANE + o] = a1 / wsum;
    dst[2 * PLANE + o] = a2 / wsum;
  }
}

__global__ void __launch_bounds__(THREADS)
    epf_kernel(const float* __restrict__ img,
               const float* __restrict__ blocks, float* __restrict__ out,
               EpfParams p) {
  extern __shared__ float smem[];
  float* a = smem;
  float* b = smem + 3 * PLANE;
  const int y0 = blockIdx.y * TILE - HALO;
  const int x0 = blockIdx.x * TILE - HALO;
  const size_t hw = (size_t)p.h * p.w;
  img += blockIdx.z * 3 * hw;
  out += blockIdx.z * 3 * hw;
  blocks += blockIdx.z * p.map_stride;

  for (int i = threadIdx.x; i < 3 * PLANE; i += blockDim.x) {
    const int c = i / PLANE;
    const int r = i - c * PLANE;
    const int gy = mirror(y0 + r / REG, p.h);
    const int gx = mirror(x0 + r % REG, p.w);
    a[i] = __ldg(img + c * hw + (size_t)gy * p.w + gx);
  }
  __syncthreads();

  int m = 0;
  if (p.gab) {
    m += 1;
    gaborish_stage(a, b, m, p);
    float* t = a; a = b; b = t;
    __syncthreads();
  }
  if (p.epf_iters >= 3) {
    m += 3;
    epf_stage<12, true>(a, b, m, kEpf0, p.mul_in[0], p.mul_border[0],
                        blocks, y0, x0, p);
    float* t = a; a = b; b = t;
    __syncthreads();
  }
  if (p.epf_iters >= 1) {
    m += 2;
    epf_stage<4, true>(a, b, m, kCross, p.mul_in[1], p.mul_border[1],
                       blocks, y0, x0, p);
    float* t = a; a = b; b = t;
    __syncthreads();
  }
  if (p.epf_iters >= 2) {
    m += 1;
    epf_stage<4, false>(a, b, m, kCross, p.mul_in[2], p.mul_border[2],
                        blocks, y0, x0, p);
    float* t = a; a = b; b = t;
    __syncthreads();
  }

  for (int i = threadIdx.x; i < 3 * TILE * TILE; i += blockDim.x) {
    const int c = i / (TILE * TILE);
    const int r = i - c * TILE * TILE;
    const int ty = r / TILE, tx = r % TILE;
    const int gy = blockIdx.y * TILE + ty, gx = blockIdx.x * TILE + tx;
    if (gy < p.h && gx < p.w)
      out[c * hw + (size_t)gy * p.w + gx] =
          a[c * PLANE + (ty + HALO) * REG + tx + HALO];
  }
}

// img and out: n contiguous (3, h, w) frames; blocks: n maps of
// map_stride floats each (map_stride 0: one map for every frame), rows
// of bw. consts (host memory, 19 floats): gaborish (w0, w1, w2) x 3
// channels, channel scales x 3, (mul_in, mul_border) for passes 0, 1,
// 2, min_sigma. Launches on `stream` and returns cudaGetLastError();
// does not synchronise.
extern "C" int jxl_epf_launch(const void* img, const void* blocks,
                              void* out, int n, int h, int w, int bw,
                              long long map_stride, int gab,
                              int epf_iters, const float* consts,
                              void* stream) {
  EpfParams p;
  p.h = h;
  p.w = w;
  p.bw = bw;
  p.map_stride = map_stride;
  p.gab = gab;
  p.epf_iters = epf_iters;
  for (int c = 0; c < 3; ++c)
    for (int k = 0; k < 3; ++k) p.gw[c][k] = consts[3 * c + k];
  for (int c = 0; c < 3; ++c) p.ch_scale[c] = consts[9 + c];
  for (int s = 0; s < 3; ++s) {
    p.mul_in[s] = consts[12 + 2 * s];
    p.mul_border[s] = consts[13 + 2 * s];
  }
  p.min_sigma = consts[18];
  const int smem = 2 * 3 * PLANE * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      epf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n);
  epf_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)blocks, (float*)out, p);
  return (int)cudaGetLastError();
}
