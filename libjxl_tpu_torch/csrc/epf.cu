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
// or have one each). The kernel is a template on the stages (gab,
// epf_iters), so every region width is a compile-time constant;
// jxl_epf_launch picks one of its seven instances. A block first tabulates the
// mirrored frame row and column of each of its REG = TILE + 2 * HALO
// region rows and columns (HALO = 1 + 3 + 2 + 1 = 7; symmetric
// extension, the edge pixel repeats), with bit masks of the rows and
// columns that fall on the first or last line of an 8x8 block. From the
// tables it loads the region of all three channels and a sigma plane
// (the block map's value at each region pixel) into shared memory, so
// no padded copy of the frame and none of the TPU kernel's two
// full-resolution planes is built. The stages then run in shared
// memory, ping-ponging between two image buffers, each shrinking the
// valid region by its reach (gaborish 1, pass 0 3, pass 1 2, pass 2 1);
// an EPF stage reads sigma as one word (skip below MIN_SIGMA) and its
// SAD multiplier from the masks. Mirroring commutes with every stage
// (stencils and candidate sets are symmetric), so halo pixels equal
// what the whole-frame formulation would produce after its own
// re-padding.
//
// Shared difference fields. The plus-shaped SAD of candidate c at
// pixel o sums D_c(o + t) over the five plus taps t, with
// D_c(q) = (|s0(q) - s0(q+c)| k0 + |s1(q) - s1(q+c)| k1)
// + |s2(q) - s2(q+c)| k2. Pass 0's twelve candidates are six pairs
// c, -c (candidate k and 11 - k), pass 1's four are two pairs (k and
// 3 - k), and since fl(a - b) = -fl(b - a), D_-c(q) = D_c(q - c) float
// for float. So a plus pass first writes the fields of its first half
// of candidates to shared memory, each over the box that its own taps
// and its partner's read, and each candidate then reads five words.
// Candidates accumulate in the reference's order, channels are summed
// in its order and nothing is contracted to FMA (-fmad=false), so every
// SAD, weight and sum is the float that the per-tap formulation gives,
// and the kernel rounds like the plain PyTorch version it is held
// against.
//
// Shared-memory reads of one 32 x 32 tile (gab, epf_iters 3), words:
//   stage     per tap (earlier design)    shared fields (this kernel)
//   load      -                           3 x 46^2 + 46^2 = 8,464
//   gaborish  27 x 44^2 = 52,272          52,272
//   pass 0    399 x 38^2 = 576,156        100 x 38^2 + 6 x 10,002 = 204,412
//   pass 1    135 x 34^2 = 156,060        36 x 34^2 + 6 x 2,664 = 57,600
//   pass 2    39 x 32^2 = 39,936          40 x 32^2 = 40,960
//   total     824,424: 805 per pixel      363,708: 355 per pixel
// (A plus pass reads, per pixel, 5 field words per candidate, 3 words
// per candidate pixel, 3 centre words and 1 sigma; a field word reads
// 6; the load reads the row table once per word it writes.)
//
// Shared memory (gab, epf_iters 3): two 3 x 46 x 46 image buffers
// (50,784 B), six 42 x 42 fields (42,336 B), the 46 x 46 sigma plane
// (8,464 B), the tables and masks (384 B): 101,968 B, so two blocks fit
// on an SM (jxl_epf_occupancy); without gaborish the fields are 44 x 44
// (106,096 B). A block has THREADS = 512 threads, 32 warps per SM:
// the kernel needs 32 registers, and with 8 warps per block it waited
// on shared-memory latency (512 beat 256, 384, 768 and 1024 in one
// timed comparison on an H100, PERF.md).
//
// Bound. The frame is read once and written once: at 3840x2160 that is
// 2 x 3 x 8,294,400 x 4 B = 199 MB plus the 0.5 MB block map against
// the card's memory rate, and about 520 FP32 operations per pixel
// against its FP32 rate; operations bound it. What still separates the
// kernel from that bound: pass 0 alone reads 100 shared words and does
// 180 FP32 operations per pixel (no FMA contraction), each candidate's
// loads wait on shared-memory latency, and a block's stages are
// separated by barriers with two blocks per SM to overlap them.
// Register blocking (neighbouring pixels of a column sharing plus taps
// and candidate pixels in registers), cp.async or TMA loads of the
// region and FMA contraction are the next steps.

#include <cuda_runtime.h>

#define TILE 32
#define HALO 7
#define REG (TILE + 2 * HALO)
#define PLANE (REG * REG)
#define THREADS 512
static_assert(THREADS % 64 == 0 && THREADS >= 128,
              "the tables take four warps, the load rows of 64 lanes");

struct EpfParams {
  int h, w, bw;
  long long map_stride;    // floats between the frames' block maps (0: shared)
  float gw[3][3];          // normalised gaborish (w0, w1, w2) per channel
  float ch_scale[3];       // EPF channel scales
  float mul_in[3];         // per pass: sigma multiplier inside a block
  float mul_border[3];     // per pass: on the block's edge rows/columns
  float min_sigma;
};

// Margins of the valid region after pass 0 and after pass 1.
__host__ __device__ constexpr int margin0(int gab) { return gab + 3; }
__host__ __device__ constexpr int margin1(int gab, int iters) {
  return (iters >= 3 ? margin0(gab) : gab) + 2;
}

// Words of the field buffer: pass 0's six fields of (n + 4)^2, pass 1's
// two of (n + 3)^2, n the pass's output width.
__host__ __device__ constexpr int field_words(int gab, int iters) {
  const int n0 = REG - 2 * margin0(gab) + 4;
  const int n1 = REG - 2 * margin1(gab, iters) + 3;
  const int f0 = iters >= 3 ? 6 * n0 * n0 : 0;
  const int f1 = iters >= 1 ? 2 * n1 * n1 : 0;
  return f0 > f1 ? f0 : f1;
}

// Dynamic shared memory of an instance: two image buffers, the fields,
// the sigma plane, the row and column tables and four mask words.
__host__ __device__ constexpr int smem_bytes(int gab, int iters) {
  return (6 * PLANE + field_words(gab, iters) + (iters ? PLANE : 0) +
          2 * REG + 4) * 4;
}

// Candidate k (row, column) of a pass with nc candidates, in the
// reference's order: pass 0's twelve, or the four of passes 1 and 2.
// Candidates k and nc - 1 - k are c and -c.
__device__ __forceinline__ int2 candidate(int nc, int k) {
  const int2 epf0[12] = {{-2, 0}, {-1, -1}, {-1, 0}, {-1, 1},
                         {0, -2}, {0, -1},  {0, 1},  {0, 2},
                         {1, -1}, {1, 0},   {1, 1},  {2, 0}};
  const int2 cross[4] = {{-1, 0}, {0, -1}, {0, 1}, {1, 0}};
  return nc == 12 ? epf0[k] : cross[k];
}

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

// Gaborish from src into dst over the square [M, REG - M).
template <int M>
__device__ __forceinline__ void gaborish_stage(const float* src, float* dst,
                                               const EpfParams& p) {
  constexpr int n = REG - 2 * M;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float w0 = p.gw[c][0], w1 = p.gw[c][1], w2 = p.gw[c][2];
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
      const int y = M + i / n, x = M + i % n;
      const float* s = src + c * PLANE + y * REG + x;
      dst[c * PLANE + y * REG + x] =
          s[0] * w0 + (s[-1] + s[1] + s[-REG] + s[REG]) * w1 +
          (s[-REG - 1] + s[-REG + 1] + s[REG - 1] + s[REG + 1]) * w2;
    }
  }
}

// One EPF pass with NC candidates from src into dst over the square
// [M, REG - M); PLUS: plus-shaped SAD from shared difference fields in
// fld, else the single-pixel SAD. sig: the sigma plane; rows, cols: bit
// y (x) set where region row y (column x) is a block's edge line.
template <int NC, int M, bool PLUS>
__device__ __forceinline__ void epf_pass(const float* src, float* dst,
                                         float* fld, const float* sig,
                                         unsigned long long rows,
                                         unsigned long long cols,
                                         float mul_in, float mul_border,
                                         const EpfParams& p) {
  constexpr int n = REG - 2 * M;
  constexpr int fs = n + 2 + (NC == 12 ? 2 : 1);   // field row stride
  if constexpr (PLUS) {
    // Field j holds D_c for c = candidate j over the rows
    // [M - 1 - max(c.x, 0), REG - M + 1 + max(-c.x, 0)) and likewise the
    // columns: its own taps (the output grown by 1) and those of -c,
    // D_-c(q) = D_c(q - c). Its box origin is at field word 0.
#pragma unroll
    for (int j = 0; j < NC / 2; ++j) {
      const int2 c = candidate(NC, j);
      const int by = n + 2 + (c.x < 0 ? -c.x : c.x);
      const int bx = n + 2 + (c.y < 0 ? -c.y : c.y);
      const int q0 = (M - 1 - (c.x > 0 ? c.x : 0)) * REG + M - 1 -
                     (c.y > 0 ? c.y : 0);
      // by and bx are constants once the loop over j unrolls.
      for (int i = threadIdx.x; i < by * bx; i += blockDim.x) {
        const int ly = i / bx, lx = i - ly * bx;
        const int q = q0 + ly * REG + lx;
        fld[j * fs * fs + ly * fs + lx] =
            chan_sad(src, q, q + c.x * REG + c.y, p);
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int ry = i / n, rx = i - ry * n;
    const int y = M + ry, x = M + rx;
    const int o = y * REG + x;
    const float s = sig[o];
    if (s < p.min_sigma) {
      dst[o] = src[o];
      dst[PLANE + o] = src[PLANE + o];
      dst[2 * PLANE + o] = src[2 * PLANE + o];
      continue;
    }
    const bool border = ((rows >> y) | (cols >> x)) & 1;
    const float inv_sigma = s * (border ? mul_border : mul_in);
    float a0 = src[o], a1 = src[PLANE + o], a2 = src[2 * PLANE + o];
    float wsum = 1.0f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int2 c = candidate(NC, k);
      const int co = c.x * REG + c.y;
      float sad;
      if constexpr (PLUS) {
        // Candidate k reads field j at o + t (first half) or at
        // o + t + c (second half, c = -candidate j), for the plus taps
        // t in the reference's order: (0,0), (-1,0), (0,-1), (1,0), (0,1).
        const int j = k < NC / 2 ? k : NC - 1 - k;
        const int2 cj = candidate(NC, j);
        const int sy = k < NC / 2 ? 0 : c.x, sx = k < NC / 2 ? 0 : c.y;
        const float* f =
            fld + j * fs * fs +
            (ry + 1 + (cj.x > 0 ? cj.x : 0) + sy) * fs + rx + 1 +
            (cj.y > 0 ? cj.y : 0) + sx;
        sad = f[0];
        sad = sad + f[-fs];
        sad = sad + f[-1];
        sad = sad + f[fs];
        sad = sad + f[1];
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

template <int GAB, int ITERS>
__global__ void __launch_bounds__(THREADS)
    epf_kernel(const float* __restrict__ img,
               const float* __restrict__ blocks, float* __restrict__ out,
               EpfParams p) {
  constexpr int M0 = margin0(GAB), M1 = margin1(GAB, ITERS), M2 = M1 + 1;
  extern __shared__ float smem[];
  float* a = smem;
  float* b = smem + 3 * PLANE;
  float* fld = b + 3 * PLANE;
  float* sig = fld + field_words(GAB, ITERS);
  int* rowtab = (int*)(sig + (ITERS ? PLANE : 0));
  int* coltab = rowtab + REG;
  unsigned* edge = (unsigned*)(coltab + REG);
  const int y0 = blockIdx.y * TILE - HALO;
  const int x0 = blockIdx.x * TILE - HALO;
  const size_t hw = (size_t)p.h * p.w;
  img += blockIdx.z * 3 * hw;
  out += blockIdx.z * 3 * hw;
  blocks += blockIdx.z * p.map_stride;

  // Warps 0-1 tabulate the mirrored frame row of each region row, warps
  // 2-3 the column of each region column; each warp's ballot marks the
  // ones on the first or last line of an 8x8 block.
  if (threadIdx.x < 128) {
    const bool row = threadIdx.x < 64;
    const int i = threadIdx.x & 63;
    int v = 0;
    if (i < REG) {
      v = row ? mirror(y0 + i, p.h) : mirror(x0 + i, p.w);
      (row ? rowtab : coltab)[i] = v;
    }
    const unsigned e = __ballot_sync(
        0xffffffffu, i < REG && ((v & 7) == 0 || (v & 7) == 7));
    if ((threadIdx.x & 31) == 0) edge[threadIdx.x >> 5] = e;
  }
  __syncthreads();

  // The region and the sigma plane: each lane owns one region column,
  // the 64-lane rows of the block step down the region rows.
  const int lx = threadIdx.x & 63;
  if (lx < REG) {
    const int gx = coltab[lx];
    for (int r = threadIdx.x >> 6; r < 3 * REG; r += blockDim.x >> 6) {
      const int c = r / REG, ry = r - c * REG;
      a[c * PLANE + ry * REG + lx] =
          __ldg(img + c * hw + (size_t)rowtab[ry] * p.w + gx);
    }
    if constexpr (ITERS > 0)
      for (int ry = threadIdx.x >> 6; ry < REG; ry += blockDim.x >> 6)
        sig[ry * REG + lx] =
            __ldg(blocks + (rowtab[ry] >> 3) * p.bw + (gx >> 3));
  }
  __syncthreads();
  const unsigned long long rows =
      edge[0] | (unsigned long long)edge[1] << 32;
  const unsigned long long cols =
      edge[2] | (unsigned long long)edge[3] << 32;

  if constexpr (GAB) {
    gaborish_stage<1>(a, b, p);
    float* t = a; a = b; b = t;
    __syncthreads();
  }
  if constexpr (ITERS >= 3) {
    epf_pass<12, M0, true>(a, b, fld, sig, rows, cols, p.mul_in[0],
                           p.mul_border[0], p);
    float* t = a; a = b; b = t;
    __syncthreads();
  }
  if constexpr (ITERS >= 1) {
    epf_pass<4, M1, true>(a, b, fld, sig, rows, cols, p.mul_in[1],
                          p.mul_border[1], p);
    float* t = a; a = b; b = t;
    __syncthreads();
  }
  if constexpr (ITERS >= 2) {
    epf_pass<4, M2, false>(a, b, fld, sig, rows, cols, p.mul_in[2],
                           p.mul_border[2], p);
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

// ---- host side ----

typedef void (*EpfKernel)(const float*, const float*, float*, EpfParams);

struct Instance {
  EpfKernel fn;
  int smem;
};

template <int GAB, int ITERS>
static Instance instance() {
  return {epf_kernel<GAB, ITERS>, smem_bytes(GAB, ITERS)};
}

// The instance for the stages: epf_iters above 3 runs three passes and
// below 0 none, as the reference's comparisons do. Without gaborish and
// EPF there is nothing to run (the wrapper returns its input), and the
// instance has no kernel.
static Instance pick(int gab, int epf_iters) {
  const int it = epf_iters < 0 ? 0 : epf_iters > 3 ? 3 : epf_iters;
  switch ((gab ? 4 : 0) + it) {
    case 0: return {nullptr, 0};
    case 1: return instance<0, 1>();
    case 2: return instance<0, 2>();
    case 3: return instance<0, 3>();
    case 4: return instance<1, 0>();
    case 5: return instance<1, 1>();
    case 6: return instance<1, 2>();
    default: return instance<1, 3>();
  }
}

static cudaError_t allow_smem(const Instance& k) {
  return cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
}

// img and out: n contiguous (3, h, w) frames; blocks: n maps of
// map_stride floats each (map_stride 0: one map for every frame), rows
// of bw. consts (host memory, 19 floats): gaborish (w0, w1, w2) x 3
// channels, channel scales x 3, (mul_in, mul_border) for passes 0, 1,
// 2, min_sigma. Launches on `stream` and returns cudaGetLastError();
// does not synchronise. With no stage (gab 0, epf_iters <= 0) it
// launches nothing and returns cudaErrorInvalidValue.
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
  for (int c = 0; c < 3; ++c)
    for (int k = 0; k < 3; ++k) p.gw[c][k] = consts[3 * c + k];
  for (int c = 0; c < 3; ++c) p.ch_scale[c] = consts[9 + c];
  for (int s = 0; s < 3; ++s) {
    p.mul_in[s] = consts[12 + 2 * s];
    p.mul_border[s] = consts[13 + 2 * s];
  }
  p.min_sigma = consts[18];
  const Instance k = pick(gab, epf_iters);
  if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(k);
  if (err != cudaSuccess) return (int)err;
  const float* src = (const float*)img;
  const float* map = (const float*)blocks;
  float* dst = (float*)out;
  void* args[] = {&src, &map, &dst, &p};
  dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, n);
  err = cudaLaunchKernel(reinterpret_cast<const void*>(k.fn), grid,
                         dim3(THREADS), args, k.smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the instance that (gab, epf_iters) launch,
// or minus the CUDA error (cudaErrorInvalidValue: no stage).
extern "C" int jxl_epf_occupancy(int gab, int epf_iters) {
  const Instance k = pick(gab, epf_iters);
  if (k.fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(k);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k.fn,
                                                        THREADS, k.smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Dynamic shared memory (bytes) of that instance's block.
extern "C" int jxl_epf_shared_bytes(int gab, int epf_iters) {
  return pick(gab, epf_iters).smem;
}
