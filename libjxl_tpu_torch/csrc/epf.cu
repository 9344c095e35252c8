// Fused gaborish + EPF loop-filter chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel libjxl_tpu/ops/epf_pallas.py
// (apply_loop_filters_pallas, kernel body _build_kernel.kernel) and
// computes what its reference libjxl_tpu/ops/filters_tpu.py computes:
// gaborish 3x3, then EPF pass 0 (12 candidates, plus-shaped SAD),
// pass 1 (4 cross candidates, plus SAD), pass 2 (4 cross candidates,
// single-pixel SAD), with the stages chosen by `gab` and `epf_iters`.
//
// Tiles. One thread block owns one TILE x TILE output tile of one frame
// of a batch (blockIdx.z; a batch is one launch, as the reference's vmap
// is one dispatch, and frames may share one block map or have one
// each). The kernel is a template on the stages (gab, epf_iters), so
// every width below is a compile-time constant; jxl_epf_launch picks
// one of its seven instances. A block tabulates the mirrored frame row
// and column of each of its REG = TILE + 2 * HALO region rows and
// columns (HALO = 1 + 3 + 2 + 1 = 7; symmetric extension, the edge
// pixel repeats), with bit masks of the rows and columns on the first or
// last line of an 8x8 block, and loads the region of all three channels
// and a sigma plane (the block map's value at each region pixel) into
// shared memory. The stages then ping-pong between two image buffers;
// each writes the square that the stages after it read (margins counted
// back from the tile), and the last one writes the tile to the frame.
// Mirroring commutes with every stage (stencils and candidate sets are
// symmetric), so halo pixels equal what the whole-frame formulation
// gives after its own re-padding.
//
// Strips. A thread computes a strip of R vertically adjacent outputs of
// one column (R = ROWS = 8 in an EPF pass; 12 for gaborish and 14 or 8
// for the fields, the heights with the fewest lane rows for their
// boxes) and loads each shared word that its strip needs once: the
// words its rows share (plus taps, candidate pixels, the window of the
// fields) are reused from registers, and the R rows are R independent
// chains, so the thread itself hides the latency of its loads and
// arithmetic. Lane l of a stage takes strip l / P and column l % P, with
// lane rows of P >= n lanes (lanes past n idle). Every plane has a row
// stride of STRIDE = 49 words, chosen so that R * STRIDE = P (mod 32)
// (8 * 49 = 40 mod 32 for the 34- and 38-wide passes, 12 * 49 = 44 for
// gaborish, 14 * 49 = 46 for pass 0's fields; lane rows of 32 never
// straddle): a warp's lanes then read 32 consecutive banks even where
// it spans two strips, and only the warp that reaches the last strip of
// a stage (which ends on the stage's last row, overlapping the one
// before it) can meet a two-way conflict. Each stage is one round of
// at most 200 busy lanes of the block's 256, so every busy thread does
// one strip: equal work, no division by a runtime value. An EPF pass
// stores its strip only at the end, and a thread issues all its region
// loads before its first store, so no store stands between a load and
// the reuse of its word. The division that ends each pass is exact
// without a branch (quotient()): the IEEE division's branch to its slow
// path split a strip into one block of code per division and kept the
// compiler from overlapping its rows.
//
// Shared difference fields. The plus-shaped SAD of candidate c at pixel
// o sums D_c(o + t) over the five plus taps t, with
// D_c(q) = (|s0(q) - s0(q+c)| k0 + |s1(q) - s1(q+c)| k1)
// + |s2(q) - s2(q+c)| k2. Pass 0's twelve candidates are six pairs
// c, -c (candidate k and 11 - k), pass 1's four are two pairs (k and
// 3 - k), and since fl(a - b) = -fl(b - a), D_-c(q) = D_c(q - c) float
// for float. A plus pass first writes the fields of its first half of
// candidates over their union box (one sliding window of 4 (pass 0) or
// 2 (pass 1) columns of the three channels gives a strip row of every
// field); a candidate then reads its field at the centre column over
// R + 2 rows and the side columns over R rows, shared with its partner
// where their taps meet. Candidates accumulate in the reference's
// order, plus taps sum in the order (0,0), (-1,0), (0,-1), (1,0),
// (0,1), channels in the order 0, 1, 2, nothing is contracted to FMA
// (-fmad=false) and every quotient is the IEEE one, so every SAD,
// weight, sum and output is the float that the per-tap formulation
// gives, and the kernel rounds like the plain PyTorch version it is
// held against.
//
// Shared-memory reads of one 32 x 32 tile (gab, epf_iters 3), words:
//   stage      shared fields (before)          strips (this kernel)
//   load       3 x 46^2 + 46^2 = 8,464         46^2 + 5 x 46 = 2,346
//   masks      -                               4 x 256 = 1,024
//   gaborish   27 x 44^2 = 52,272              126 x 176 = 22,176
//   pass 0     100 x 38^2 + 6 x 10,002         177 x 129 (fields)
//              = 204,412                       + 365 x 190 = 92,183
//   pass 1     36 x 34^2 + 6 x 2,664           51 x 185 (fields)
//              = 57,600                        + 151 x 170 = 35,105
//   pass 2     40 x 32^2 = 40,960              86 x 128 = 11,008
//   total      363,708: 355 per pixel          163,842: 160 per pixel
// (words of one strip x busy lanes. A gaborish strip of 12 rows reads
// 3 channels x 3 columns x 14 rows; pass 0's fields 3 x 4 x 16 less
// the 15 window words no field needs; a pass 0 strip 291 field words,
// 3 x 24 candidate pixels and 8 sigma words; pass 1's fields
// 3 x (2 x 9 - 1); a pass 1 strip 103 field words, 3 x 13 pixels and
// 8 sigma words; a pass 2 strip 3 x 26 pixels and 8 sigma words. The
// load reads the row table once per region pixel for its three channels
// and sigma, and the column table once per lane.)
//
// Shared memory (gab, epf_iters 3): two 3 x 46 x 49 image buffers
// (54,096 B), six 42-row fields (49,392 B), the sigma plane (9,016 B),
// the tables and masks (384 B): 112,888 B, so two blocks fit on an SM
// (jxl_epf_occupancy). A block has THREADS = 256 threads, capped at 128
// registers each so that two blocks fit (__launch_bounds__); the main
// instance needs 121, with no spills.
//
// Bound. The frame is read once and written once: at 3840x2160 that is
// 2 x 3 x 8,294,400 x 4 B = 199 MB plus the 0.5 MB block map against
// the card's memory rate (0.0596 ms), and about 520 FP32 operations per
// pixel against its FP32 rate (0.0655 ms, counting an FMA as two);
// operations bound it. Without contraction every mul and add issues on
// its own, so this arithmetic's floor is about 0.13 ms. What still
// separates the kernel from that: the region load, which every block
// waits for and which blocks tend to make at once (the instance with
// gaborish alone, load, one stage and store, takes a quarter of the
// whole chain's time); the halo that each stage recomputes (44^2, 38^2,
// 34^2 and 32^2 outputs for 32^2, about 1.3x the work); the loads,
// conversions and selects that issue beside the FP32 operations; idle
// lanes (a stage keeps 4 to 6.25 of its 8 warps busy); and the
// barriers between seven phases, which only the other resident block
// overlaps. cp.async or TMA loads of the next tile in persistent
// blocks, FMA contraction, the PQ16 tail as an epilogue and a tile-size
// search are the next steps.

#include <cuda_runtime.h>

#define TILE 32
#define HALO 7
#define REG (TILE + 2 * HALO)
#define ROWS 8           // rows of an EPF pass's strip
#define THREADS 256
static_assert(THREADS % 32 == 0 && THREADS >= 128,
              "the tables take four warps");

// Row stride of every shared plane: the least width >= REG with
// ROWS * STRIDE = 8 (mod 32), so that a pass's lane rows of 40 (and 32)
// lanes keep the banks of a warp consecutive across strips.
__host__ __device__ constexpr int row_stride() {
  int s = REG;
  while ((ROWS * s) % 32 != 8) ++s;
  return s;
}
constexpr int STRIDE = row_stride();
constexpr int PLANE = REG * STRIDE;

struct EpfParams {
  int h, w, bw;
  long long map_stride;    // floats between the frames' block maps (0: shared)
  float gw[3][3];          // normalised gaborish (w0, w1, w2) per channel
  float ch_scale[3];       // EPF channel scales
  float mul_in[3];         // per pass: sigma multiplier inside a block
  float mul_border[3];     // per pass: on the block's edge rows/columns
  float min_sigma;
};

// Candidate k (row dy, column dx) of a pass with nc candidates, in the
// reference's order: pass 0's twelve (-2,0) (-1,-1) (-1,0) (-1,1)
// (0,-2) (0,-1) (0,1) (0,2) (1,-1) (1,0) (1,1) (2,0), or the cross
// (-1,0) (0,-1) (0,1) (1,0) of passes 1 and 2. Candidates k and
// nc - 1 - k are c and -c.
__host__ __device__ constexpr int cand_dy(int nc, int k) {
  return nc == 12 ? (k == 0 ? -2 : k <= 3 ? -1 : k <= 7 ? 0 : k <= 10 ? 1 : 2)
                  : (k == 0 ? -1 : k == 3 ? 1 : 0);
}
__host__ __device__ constexpr int cand_dx(int nc, int k) {
  return nc == 12 ? (k == 4 ? -2 : k == 7 ? 2
                     : (k == 1 || k == 5 || k == 8) ? -1
                     : (k == 3 || k == 6 || k == 10) ? 1 : 0)
                  : (k == 1 ? -1 : k == 2 ? 1 : 0);
}

// Stage margins, counted back from the tile: the last stage writes the
// TILE x TILE tile (margin HALO), each stage before it the square that
// the next one reads (gaborish reaches 1, pass 0 3, pass 1 2, pass 2 1).
__host__ __device__ constexpr int margin1(int iters) {
  return iters >= 2 ? HALO - 1 : HALO;
}
__host__ __device__ constexpr int margin0(int iters) {
  return margin1(iters) - 2;
}
__host__ __device__ constexpr int margin_gab(int iters) {
  return iters >= 3 ? margin0(iters) - 3
         : iters >= 1 ? margin1(iters) - 2 : HALO;
}

// How far the second half of a plus pass's candidates shifts the plus
// taps (D_-c(q) = D_c(q - c)) below (sign 1) or above (sign -1), or
// right or left (col), of the output square.
__host__ __device__ constexpr int shift_reach(int nc, bool col, int sign) {
  int m = 0;
  for (int j = 0; j < nc / 2; ++j) {
    const int v = -(col ? cand_dx(nc, j) : cand_dy(nc, j)) * sign;
    if (v > m) m = v;
  }
  return m;
}
// The box of a plus pass's difference fields around its n x n output
// square at margin m: the output grown by the taps and the shifts.
__host__ __device__ constexpr int field_top(int nc, int m) {
  return m - 1 - shift_reach(nc, false, -1);
}
__host__ __device__ constexpr int field_left(int nc, int m) {
  return m - 1 - shift_reach(nc, true, -1);
}
__host__ __device__ constexpr int field_rows(int nc, int n) {
  return n + 2 + shift_reach(nc, false, -1) + shift_reach(nc, false, 1);
}
__host__ __device__ constexpr int field_cols(int nc, int n) {
  return n + 2 + shift_reach(nc, true, -1) + shift_reach(nc, true, 1);
}

// Lanes of a lane row: the least p >= width that keeps the banks of a
// warp consecutive across strips of r rows (r * STRIDE = p mod 32), or
// a multiple of 32 (no warp spans two strips).
__host__ __device__ constexpr int lane_width(int r, int width) {
  int p = width;
  while (p % 32 != 0 && (r * STRIDE - p) % 32 != 0) ++p;
  return p;
}
// Strip height of a stage that holds no rows in registers (gaborish, the
// fields): the r in 8..16 with the fewest lane rows for the box.
__host__ __device__ constexpr int strip_rows(int height, int width) {
  int best = 8, cost = 1 << 30;
  for (int r = 8; r <= 16; ++r) {
    const int c = lane_width(r, width) * ((height + r - 1) / r) * r;
    if (c < cost) {
      cost = c;
      best = r;
    }
  }
  return best;
}

// Words of the field buffer: pass 0's six fields, or pass 1's two.
__host__ __device__ constexpr int field_words(int iters) {
  const int f0 = iters >= 3
      ? 6 * field_rows(12, REG - 2 * margin0(iters)) * STRIDE : 0;
  const int f1 = iters >= 1
      ? 2 * field_rows(4, REG - 2 * margin1(iters)) * STRIDE : 0;
  return f0 > f1 ? f0 : f1;
}

// Dynamic shared memory of an instance: two image buffers, the fields,
// the sigma plane, the row and column tables and four mask words.
__host__ __device__ constexpr int smem_bytes(int gab, int iters) {
  return (6 * PLANE + field_words(iters) + (iters ? PLANE : 0) +
          2 * REG + 4) * 4;
}

// Symmetric extension of an axis of length n ('abc' -> 'cba|abc|cba').
__device__ __forceinline__ int mirror(int i, int n) {
  const int p = 2 * n;
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - 1 - i;
}

// ((0 + d0) + d1) + d2 of |a - b| per channel, in the reference's order.
__device__ __forceinline__ float chan_sad(const float* a, const float* b,
                                          const EpfParams& p) {
  float d = fabsf(a[0] - b[0]) * p.ch_scale[0];
  d = d + fabsf(a[PLANE] - b[PLANE]) * p.ch_scale[1];
  d = d + fabsf(a[2 * PLANE] - b[2 * PLANE]) * p.ch_scale[2];
  return d;
}

// 1/w in double for a positive float w (an EPF weight sum, 1 to 13):
// the approximate reciprocal refined by two Newton steps, well within
// the 2^-29 that quotient() needs.
__device__ __forceinline__ double reciprocal(float w) {
  const double d = w;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  r = __fma_rn(r, __fma_rn(-d, r, 1.0), r);
  return __fma_rn(r, __fma_rn(-d, r, 1.0), r);
}

// a / w as IEEE float division rounds it, for a finite a and a finite
// w > 0, from rw = reciprocal(w), with no slow path to branch to (a
// branch per division kept the compiler from overlapping a strip's
// rows). In double, q = a * rw is within 2^-29 of a / w, so the
// remainder a - w q is exact and q + (a - w q) rw is a / w to within
// half a double ulp, and exactly a / w where that is a float rounding
// midpoint. A quotient of two floats that is not a midpoint lies at
// least 2^-49 of its size away from every midpoint (2^-174 in the
// subnormal range), far beyond that error, so the one rounding to float
// gives the float that a / w rounds to. The sign is copied from a,
// which keeps a -0 dividend's zero negative. (A weight sum is at least
// 1 and finite for finite frames; on frames with infinities or NaNs the
// kernel and its plain version already part, as fmaxf(NaN, 0) is 0.)
__device__ __forceinline__ float quotient(float a, float w, double rw) {
  const double q = (double)a * rw;
  return copysignf(
      (float)__fma_rn(__fma_rn(-(double)w, q, (double)a), rw, q), a);
}

// Where the last stage writes: the frame, at the block's tile.
struct Out {
  float* img;
  size_t hw;
  int h, w, y0, x0;   // frame size; frame row and column of region (0, 0)
};

template <bool LAST>
__device__ __forceinline__ void put(float* dst, const Out& o, int c, int y,
                                    int x, float v) {
  if constexpr (LAST) {
    const int gy = o.y0 + y, gx = o.x0 + x;
    if (gy < o.h && gx < o.w) o.img[c * o.hw + (size_t)gy * o.w + gx] = v;
  } else {
    dst[c * PLANE + y * STRIDE + x] = v;
  }
}

// Runs f(strip row, column) for the strips of R rows of an H x W box:
// lane l takes strip l / P and column l % P (lanes past W idle), so a
// warp's lanes read consecutive words; the last strip ends at the box's
// last row and may overlap the one before it (both write equal values).
template <int R, int P, int H, int W, typename F>
__device__ __forceinline__ void for_strips(F&& f) {
  static_assert(H >= R && P >= W, "a strip fits in its box");
  constexpr int ns = (H + R - 1) / R;
  for (int l = threadIdx.x; l < ns * P; l += THREADS) {
    const int s = l / P, x = l - s * P;
    if (x < W) f(s * R < H - R ? s * R : H - R, x);
  }
}

// Gaborish from src into dst over the n x n square at margin M. A
// thread slides a 3 x 3 window down its strip, one new row of three
// words per output.
template <int M, bool LAST>
__device__ __forceinline__ void gaborish_stage(const float* __restrict__ src,
                                               float* __restrict__ dst,
                                               const EpfParams& p,
                                               const Out& out) {
  constexpr int n = REG - 2 * M;
  constexpr int R = strip_rows(n, n), P = lane_width(R, n);
  for_strips<R, P, n, n>([&](int sy, int sx) {
    const int y = M + sy, x = M + sx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float w0 = p.gw[c][0], w1 = p.gw[c][1], w2 = p.gw[c][2];
      const float* s = src + c * PLANE + (y - 1) * STRIDE + x - 1;
      float v[R + 2][3];
#pragma unroll
      for (int r = 0; r < R + 2; ++r) {
#pragma unroll
        for (int i = 0; i < 3; ++i) v[r][i] = s[r * STRIDE + i];
        if (r < 2) continue;
        // Rows r - 2 (up), r - 1 (the output's) and r (down).
        put<LAST>(dst, out, c, y + r - 2, x,
                  v[r - 1][1] * w0 +
                      (v[r - 1][0] + v[r - 1][2] + v[r - 2][1] + v[r][1]) *
                          w1 +
                      (v[r - 2][0] + v[r - 2][2] + v[r][0] + v[r][2]) * w2);
      }
    }
  });
}

// The difference fields of a plus pass with NC candidates and an n x n
// output at margin M: field j holds D_c(q) = sum over channels of
// |s(q) - s(q + c)| * scale for c = candidate j (the first half), over
// the union box of every field, row q - field_top at plane j. A thread
// slides a window of the columns and rows that the candidates reach
// down its strip: one new row of 4 (pass 0) or 2 (pass 1) words per
// channel gives a strip row of every field.
template <int NC, int M>
__device__ __forceinline__ void field_stage(const float* __restrict__ src,
                                            float* __restrict__ fld,
                                            const EpfParams& p) {
  constexpr int n = REG - 2 * M;
  constexpr int FY = field_top(NC, M), FX = field_left(NC, M);
  constexpr int FH = field_rows(NC, n), FW = field_cols(NC, n);
  constexpr int FPL = FH * STRIDE;
  constexpr int R = strip_rows(FH, FW), P = lane_width(R, FW);
  constexpr int UP = NC == 12 ? 2 : 1, LO = NC == 12 ? 2 : 1;
  constexpr int NX = NC == 12 ? 4 : 2;     // columns x - LO .. x - LO + NX
  for_strips<R, P, FH, FW>([&](int sy, int sx) {
    const int x = FX + sx;
    const float* s = src + (FY + sy - UP) * STRIDE + x - LO;
    float* f = fld + sy * STRIDE + x;
    float v[3][R + UP][NX];
#pragma unroll
    for (int r = 0; r < R + UP; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < NX; ++i)
          v[c][r][i] = s[c * PLANE + r * STRIDE + i];
      if (r < UP) continue;
#pragma unroll
      for (int j = 0; j < NC / 2; ++j) {
        const int dy = cand_dy(NC, j), dx = cand_dx(NC, j);
        float d = fabsf(v[0][r][LO] - v[0][r + dy][LO + dx]) * p.ch_scale[0];
        d = d + fabsf(v[1][r][LO] - v[1][r + dy][LO + dx]) * p.ch_scale[1];
        d = d + fabsf(v[2][r][LO] - v[2][r + dy][LO + dx]) * p.ch_scale[2];
        f[j * FPL + (r - UP) * STRIDE] = d;
      }
    }
  });
}

// One EPF pass with NC candidates from src over the n x n square at
// margin M, into dst or, for the last stage, the frame. PLUS: plus-shaped
// SAD from the fields in fld, else the single-pixel SAD. sig: the sigma
// plane; rows, cols: bit y (x) set where region row y (column x) is a
// block's edge line. A thread filters a strip of ROWS pixels of one
// column. Its loads are plain loads of compile-time offsets from three
// base pointers and it stores only at the end, so each field, pixel and
// sigma word that its rows share is loaded once and reused from a
// register; every row is an independent chain.
template <int NC, int M, bool PLUS, bool LAST>
__device__ __forceinline__ void epf_pass(const float* __restrict__ src,
                                         float* __restrict__ dst,
                                         const float* __restrict__ fld,
                                         const float* __restrict__ sig,
                                         unsigned long long rows,
                                         unsigned long long cols,
                                         float mul_in, float mul_border,
                                         const EpfParams& p, const Out& out) {
  constexpr int n = REG - 2 * M;
  constexpr int R = ROWS, P = lane_width(R, n);
  constexpr int FY = field_top(NC, M), FPL = field_rows(NC, n) * STRIDE;
  for_strips<R, P, n, n>([&](int sy, int sx) {
    const int y = M + sy, x = M + sx;
    const float* s = src + y * STRIDE + x;
    const float* g = sig + y * STRIDE + x;
    const float* f = fld + (y - FY) * STRIDE + x;
    const unsigned long long rb = rows >> y;
    const bool cb = (cols >> x) & 1;
    float isg[R];
    unsigned on = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sg = g[r * STRIDE];
      isg[r] = sg * ((cb || ((rb >> r) & 1)) ? mul_border : mul_in);
      on |= (sg < p.min_sigma ? 0u : 1u) << r;
    }
    float v[3][R];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c][r] = s[c * PLANE + r * STRIDE];
    if (on != 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* o = s + r * STRIDE;
        float a0 = o[0], a1 = o[PLANE], a2 = o[2 * PLANE];
        float ws = 1.0f;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int dy = cand_dy(NC, k), dx = cand_dx(NC, k);
          float sad;
          if constexpr (PLUS) {
            // Candidate k reads field j at o + t (first half) or at
            // o + t + c (second half, c = -candidate j), for the plus
            // taps t in the reference's order: (0,0), (-1,0), (0,-1),
            // (1,0), (0,1).
            const bool first = k < NC / 2;
            const int j = first ? k : NC - 1 - k;
            const float* d = f + j * FPL + (r + (first ? 0 : dy)) * STRIDE +
                             (first ? 0 : dx);
            sad = d[0];
            sad = sad + d[-STRIDE];
            sad = sad + d[-1];
            sad = sad + d[STRIDE];
            sad = sad + d[1];
          } else {
            sad = chan_sad(o + dy * STRIDE + dx, o, p);
          }
          const float wgt = fmaxf(sad * isg[r] + 1.0f, 0.0f);
          const float* q = o + dy * STRIDE + dx;
          a0 = a0 + wgt * q[0];
          a1 = a1 + wgt * q[PLANE];
          a2 = a2 + wgt * q[2 * PLANE];
          ws = ws + wgt;
        }
        const bool filt = (on >> r) & 1;
        const double rw = reciprocal(ws);
        v[0][r] = filt ? quotient(a0, ws, rw) : v[0][r];
        v[1][r] = filt ? quotient(a1, ws, rw) : v[1][r];
        v[2][r] = filt ? quotient(a2, ws, rw) : v[2][r];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) put<LAST>(dst, out, c, y + r, x, v[c][r]);
  });
}

template <int GAB, int ITERS>
__global__ void __launch_bounds__(THREADS, 2)
    epf_kernel(const float* __restrict__ img,
               const float* __restrict__ blocks, float* __restrict__ out,
               EpfParams p) {
  constexpr int M1 = margin1(ITERS), M0 = margin0(ITERS);
  extern __shared__ float smem[];
  float* a = smem;
  float* b = smem + 3 * PLANE;
  float* fld = b + 3 * PLANE;
  float* sig = fld + field_words(ITERS);
  int* rowtab = (int*)(sig + (ITERS ? PLANE : 0));
  int* coltab = rowtab + REG;
  unsigned* edge = (unsigned*)(coltab + REG);
  const int y0 = blockIdx.y * TILE - HALO;
  const int x0 = blockIdx.x * TILE - HALO;
  const size_t hw = (size_t)p.h * p.w;
  img += blockIdx.z * 3 * hw;
  blocks += blockIdx.z * p.map_stride;
  const Out dst_img = {out + blockIdx.z * 3 * hw, hw, p.h, p.w, y0, x0};

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

  // The region and the sigma plane: lane rows of STRIDE lanes, each lane
  // owning one region column, step down the region rows; a lane reads
  // its row's table entry once for the three channels and sigma, and
  // issues all its loads before its first store, so the block waits for
  // one round trip to memory, not one per row.
  {
    constexpr int LR = THREADS / STRIDE, NR = (REG + LR - 1) / LR;
    const int lr = threadIdx.x / STRIDE, lx = threadIdx.x - lr * STRIDE;
    if (lr < LR && lx < REG) {
      const int gx = coltab[lx];
      float v[NR][4];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int ry = lr + i * LR;
        if (ry < REG) {
          const int gy = rowtab[ry];
          const float* s = img + (size_t)gy * p.w + gx;
          v[i][0] = __ldg(s);
          v[i][1] = __ldg(s + hw);
          v[i][2] = __ldg(s + 2 * hw);
          if constexpr (ITERS > 0)
            v[i][3] = __ldg(blocks + (gy >> 3) * p.bw + (gx >> 3));
        }
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int ry = lr + i * LR;
        if (ry < REG) {
          float* d = a + ry * STRIDE + lx;
          d[0] = v[i][0];
          d[PLANE] = v[i][1];
          d[2 * PLANE] = v[i][2];
          if constexpr (ITERS > 0) sig[ry * STRIDE + lx] = v[i][3];
        }
      }
    }
  }
  __syncthreads();
  const unsigned long long rows =
      edge[0] | (unsigned long long)edge[1] << 32;
  const unsigned long long cols =
      edge[2] | (unsigned long long)edge[3] << 32;

  if constexpr (GAB) {
    gaborish_stage<margin_gab(ITERS), ITERS == 0>(a, b, p, dst_img);
    float* t = a; a = b; b = t;
    __syncthreads();
  }
  if constexpr (ITERS >= 3) {
    field_stage<12, M0>(a, fld, p);
    __syncthreads();
    epf_pass<12, M0, true, false>(a, b, fld, sig, rows, cols, p.mul_in[0],
                                  p.mul_border[0], p, dst_img);
    float* t = a; a = b; b = t;
    __syncthreads();
  }
  if constexpr (ITERS >= 1) {
    field_stage<4, M1>(a, fld, p);
    __syncthreads();
    epf_pass<4, M1, true, ITERS == 1>(a, b, fld, sig, rows, cols,
                                      p.mul_in[1], p.mul_border[1], p,
                                      dst_img);
    float* t = a; a = b; b = t;
    __syncthreads();
  }
  if constexpr (ITERS >= 2)
    epf_pass<4, HALO, false, true>(a, b, fld, sig, rows, cols, p.mul_in[2],
                                   p.mul_border[2], p, dst_img);
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
