// BatchNorm in train mode over a channels-last activation, with the ReLU
// (and the residual sum) that follows it in a ResNet block fused in.
//
// Replaces no TPU kernel: the JAX package leaves flax's BatchNorm to XLA,
// which fuses its passes into their neighbours. The arithmetic is flax's
// (ops/batch_norm.py holds the plain twin): f32 statistics with the fast
// variance max(E[x^2] - E[x]^2, 0), rstd = 1 / sqrt(var + eps),
// y = (x - mean) * (rstd * scale) + bias rounded once to x's dtype, then
// optionally relu(y) or relu(y + residual), each sum rounded to x's dtype
// as the separate ops round it. The backward is the closed form
// scale * rstd * (g' - mean(g') - xhat * mean(g' * xhat)), g' the gradient
// masked where the ReLU's output is not positive, the last term dropped on
// a channel whose variance was clipped.
//
// Bound by bytes. x is (rows = N*H*W, C) in bf16 or f32, C contiguous.
// Four passes, each streaming its tensors once:
//   bn_stats     read x                      per-channel sums of x, x^2
//   bn_apply     read x (+ residual), write y
//   bn_grad_sums read g, x (+ y for the mask) sums of g', g' * xhat
//   bn_dx        read g, x (+ y), write dx (+ g' for the residual)
// At ResNet-50's 2.85 G BatchNorm elements a step of 256 images that is
// 16-22 bytes an element in bf16, against ~150 for the f32 PyTorch passes
// it replaces.
//
// Design against the bound: a thread owns VEC neighbouring channels (a
// 16-byte load: 8 bf16 or 4 f32; 8, 4 or 2 bytes where C is no multiple
// of that) for the whole launch, so its per-channel constants sit in
// registers and its loads need no index arithmetic beyond a row stride.
// A block is TX channel groups (at most 32, neighbouring lanes on
// neighbouring addresses) by TY = 256 / TX rows; the grid is the channel
// tiles by as many row blocks as fill the card about 8 blocks deep, each
// block striding over the rows. The sums are deterministic with no float
// atomics: each thread sums its rows in order, the block's rows are added
// in a fixed tree in shared memory, and a second small launch adds the
// row blocks' partial sums in a fixed order. The same input on the same
// card gives the same bits. The apply and the dx pass use the rounding
// intrinsics (no contracted FMAs), so given the same statistics they give
// the twin's bits.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
// Finishing launch: kFinishCols columns by kFinishLanes lanes a block.
constexpr int kFinishCols = 32;
constexpr int kFinishLanes = 32;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float from_f32(float v, float*) { return v; }
__device__ __forceinline__ bf16 from_f32(float v, bf16*) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T to_type(float v) {
  return from_f32(v, static_cast<T*>(nullptr));
}

// v rounded to T and back: the cast to x's dtype of the reference.
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_f32(to_type<T>(v));
}

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(pk.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&in)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = to_type<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// The gradient that reaches the norm through relu: F.relu's backward
// passes g where the output is positive and 0 elsewhere.
__device__ __forceinline__ float masked(float g, float out) {
  return out <= 0.f ? 0.f : g;
}

// Adds a[] and b[] over the block's rows (threadIdx.y) in a fixed tree;
// row 0's threads hold the block's sums after. sh holds 2 * VEC * the
// block's threads floats, laid out [which][i][ty][tx] (no bank conflicts).
template <int VEC>
__device__ __forceinline__ void sum_rows(float (&a)[VEC], float (&b)[VEC],
                                         float* sh) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nx = blockDim.x, ny = blockDim.y;
  const int plane = nx * ny;
  float* sa = sh;
  float* sb = sh + VEC * plane;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sa[i * plane + ty * nx + tx] = a[i];
    sb[i * plane + ty * nx + tx] = b[i];
  }
  __syncthreads();
  int span = 1;
  while (span < ny) span <<= 1;
  for (int half = span >> 1; half > 0; half >>= 1) {
    if (ty < half && ty + half < ny) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sa[i * plane + ty * nx + tx] += sa[i * plane + (ty + half) * nx + tx];
        sb[i * plane + ty * nx + tx] += sb[i * plane + (ty + half) * nx + tx];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[i] = sa[i * plane + tx];
    b[i] = sb[i * plane + tx];
  }
}

// partial[blockIdx.x] (2, C) f32: this row block's sums of x and x * x.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    stats_partial(const T* __restrict__ x, float* __restrict__ partial,
                  long long rows, int C, int groups) {
  __shared__ float sh[2 * VEC * kThreads];
  const int group = blockIdx.y * blockDim.x + threadIdx.x;
  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (group < groups) {
    const T* col = x + static_cast<long long>(group) * VEC;
    const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
#pragma unroll 4
    for (long long r = static_cast<long long>(blockIdx.x) * blockDim.y +
                       threadIdx.y;
         r < rows; r += step) {
      float v[VEC];
      load<T, VEC>(col + r * C, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += v[i];
        q[i] = fmaf(v[i], v[i], q[i]);
      }
    }
  }
  sum_rows<VEC>(s, q, sh);
  if (threadIdx.y == 0 && group < groups) {
    float* dst = partial + static_cast<long long>(blockIdx.x) * 2 * C +
                 static_cast<long long>(group) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      dst[i] = s[i];
      dst[C + i] = q[i];
    }
  }
}

// out0[c] and out1[c]: columns c and C + c of the (P, 2, C) partial sums,
// added over P in order, then times a.
__global__ void __launch_bounds__(kFinishCols * kFinishLanes)
    finish(const float* __restrict__ partial, float* __restrict__ out0,
           float* __restrict__ out1, int P, int C, float a) {
  __shared__ float sh[kFinishLanes][kFinishCols + 1];
  const int col = blockIdx.x * kFinishCols + threadIdx.x;
  const long long width = 2LL * C;
  float s = 0.f;
  if (col < width) {
#pragma unroll 4
    for (int p = threadIdx.y; p < P; p += kFinishLanes) {
      s += partial[p * width + col];
    }
  }
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    for (int lane = 1; lane < kFinishLanes; ++lane) s += sh[lane][threadIdx.x];
    s = __fmul_rn(s, a);
    if (col < C) {
      out0[col] = s;
    } else {
      out1[col - C] = s;
    }
  }
}

// y = relu?(round(round((x - mean) * mul + bias) + residual)); row 0 of
// row block 0 also writes each channel's mean, var and rstd into saved
// (3, C) and the new running averages.
template <typename T, int VEC, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                 T* __restrict__ out, const float* __restrict__ moments,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ run_mean,
                 const float* __restrict__ run_var,
                 float* __restrict__ saved, float* __restrict__ new_mean,
                 float* __restrict__ new_var, long long rows, int C,
                 int groups, float eps, float keep, float take) {
  const int group = blockIdx.y * blockDim.x + threadIdx.x;
  if (group >= groups) return;
  const bool writer = blockIdx.x == 0 && threadIdx.y == 0;
  float mean[VEC], mul[VEC], add[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = group * VEC + i;
    const float m = moments[c];
    const float raw = __fsub_rn(moments[C + c], __fmul_rn(m, m));
    const float var = raw < 0.f ? 0.f : raw;
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    mean[i] = m;
    mul[i] = __fmul_rn(rstd, scale[c]);
    add[i] = bias[c];
    if (writer) {
      saved[c] = m;
      saved[C + c] = var;
      saved[2 * C + c] = rstd;
      new_mean[c] = __fadd_rn(__fmul_rn(keep, run_mean[c]), __fmul_rn(take, m));
      new_var[c] = __fadd_rn(__fmul_rn(keep, run_var[c]), __fmul_rn(take, var));
    }
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  const long long first = static_cast<long long>(group) * VEC;
#pragma unroll 2
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       r < rows; r += step) {
    const long long at = r * C + first;
    float v[VEC], rv[VEC];
    load<T, VEC>(x + at, v);
    if constexpr (RES) load<T, VEC>(res + at, rv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float y = rounded<T>(
          __fadd_rn(__fmul_rn(__fsub_rn(v[i], mean[i]), mul[i]), add[i]));
      if constexpr (RES) y = rounded<T>(__fadd_rn(y, rv[i]));
      if constexpr (RELU) y = y < 0.f ? 0.f : y;
      v[i] = y;
    }
    store<T, VEC>(out + at, v);
  }
}

// partial[blockIdx.x] (2, C): this row block's sums of g' and g' * xhat.
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
    grad_partial(const T* __restrict__ g, const T* __restrict__ x,
                 const T* __restrict__ y, const float* __restrict__ saved,
                 float* __restrict__ partial, long long rows, int C,
                 int groups) {
  __shared__ float sh[2 * VEC * kThreads];
  const int group = blockIdx.y * blockDim.x + threadIdx.x;
  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (group < groups) {
    float mean[VEC], rstd[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean[i] = saved[group * VEC + i];
      rstd[i] = saved[2 * C + group * VEC + i];
    }
    const long long first = static_cast<long long>(group) * VEC;
    const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
#pragma unroll 2
    for (long long r = static_cast<long long>(blockIdx.x) * blockDim.y +
                       threadIdx.y;
         r < rows; r += step) {
      const long long at = r * C + first;
      float gv[VEC], xv[VEC], yv[VEC];
      load<T, VEC>(g + at, gv);
      load<T, VEC>(x + at, xv);
      if constexpr (RELU) load<T, VEC>(y + at, yv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float gi = gv[i];
        if constexpr (RELU) gi = masked(gi, yv[i]);
        const float xhat = __fmul_rn(__fsub_rn(xv[i], mean[i]), rstd[i]);
        s[i] += gi;
        q[i] = fmaf(gi, xhat, q[i]);
      }
    }
  }
  sum_rows<VEC>(s, q, sh);
  if (threadIdx.y == 0 && group < groups) {
    float* dst = partial + static_cast<long long>(blockIdx.x) * 2 * C +
                 static_cast<long long>(group) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      dst[i] = s[i];
      dst[C + i] = q[i];
    }
  }
}

// dx = ((g' - sum_g * inv_n) - xhat * (sum_gx * inv_n)) * (scale * rstd),
// the middle term 0 where var was clipped; dres = g' (the residual's
// gradient). inv_n is 1/n rounded to f32: PyTorch's CUDA division by a
// scalar multiplies by that reciprocal, so the twin on the card gives the
// same bits.
template <typename T, int VEC, bool RELU, bool DRES>
__global__ void __launch_bounds__(kThreads)
    dx_kernel(const T* __restrict__ g, const T* __restrict__ x,
              const T* __restrict__ y, const float* __restrict__ saved,
              const float* __restrict__ scale,
              const float* __restrict__ sum_g,
              const float* __restrict__ sum_gx, T* __restrict__ dx,
              T* __restrict__ dres, long long rows, int C, int groups,
              float inv_n) {
  const int group = blockIdx.y * blockDim.x + threadIdx.x;
  if (group >= groups) return;
  float mean[VEC], rstd[VEC], shift[VEC], centre[VEC], mul[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = group * VEC + i;
    mean[i] = saved[c];
    rstd[i] = saved[2 * C + c];
    shift[i] = __fmul_rn(sum_g[c], inv_n);
    centre[i] = saved[C + c] > 0.f ? __fmul_rn(sum_gx[c], inv_n) : 0.f;
    mul[i] = __fmul_rn(scale[c], rstd[i]);
  }
  const long long first = static_cast<long long>(group) * VEC;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
#pragma unroll 2
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       r < rows; r += step) {
    const long long at = r * C + first;
    float gv[VEC], xv[VEC], yv[VEC];
    load<T, VEC>(g + at, gv);
    load<T, VEC>(x + at, xv);
    if constexpr (RELU) load<T, VEC>(y + at, yv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if constexpr (RELU) gv[i] = masked(gv[i], yv[i]);
      const float xhat = __fmul_rn(__fsub_rn(xv[i], mean[i]), rstd[i]);
      xv[i] = __fmul_rn(
          __fsub_rn(__fsub_rn(gv[i], shift[i]), __fmul_rn(xhat, centre[i])),
          mul[i]);
    }
    store<T, VEC>(dx + at, xv);
    if constexpr (DRES) store<T, VEC>(dres + at, gv);
  }
}

int sm_count() {
  static const int count = [] {
    int device = 0, n = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess) {
      n = 132;
    }
    return n;
  }();
  return count;
}

// Channels a thread owns: the widest load of at most 16 bytes that C
// splits into.
int pick_vec(int C, int elem_bytes) {
  for (int v = 16 / elem_bytes; v > 1; v >>= 1) {
    if (C % v == 0) return v;
  }
  return 1;
}

struct Geometry {
  int vec, groups, tx, ty, gy;
  long long gx;
};

Geometry geometry(long long rows, int C, int elem_bytes) {
  Geometry g;
  g.vec = pick_vec(C, elem_bytes);
  g.groups = C / g.vec;
  g.tx = g.groups < 32 ? g.groups : 32;
  g.ty = kThreads / g.tx;
  g.gy = (g.groups + g.tx - 1) / g.tx;
  const long long row_blocks = (rows + g.ty - 1) / g.ty;
  const long long want =
      (static_cast<long long>(sm_count()) * kBlocksPerSM + g.gy - 1) / g.gy;
  g.gx = row_blocks < want ? row_blocks : want;
  return g;
}

int finish_launch(const float* partial, float* out0, float* out1, int P,
                  int C, float a, cudaStream_t s) {
  const int cols = (2 * C + kFinishCols - 1) / kFinishCols;
  finish<<<cols, dim3(kFinishCols, kFinishLanes), 0, s>>>(partial, out0,
                                                          out1, P, C, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int stats_t(const Geometry& g, const void* x, void* partial, void* moments,
            long long rows, int C, float inv_count, cudaStream_t s) {
  stats_partial<T, VEC>
      <<<dim3(static_cast<unsigned>(g.gx), g.gy), dim3(g.tx, g.ty), 0, s>>>(
          static_cast<const T*>(x), static_cast<float*>(partial), rows, C,
          g.groups);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  float* m = static_cast<float*>(moments);
  return finish_launch(static_cast<const float*>(partial), m, m + C,
                       static_cast<int>(g.gx), C, inv_count, s);
}

template <typename T, int VEC, bool RES, bool RELU>
int apply_t(const Geometry& g, const void* x, const void* res, void* out,
            const void* moments, const void* scale, const void* bias,
            const void* run_mean, const void* run_var, void* saved,
            void* new_mean, void* new_var, long long rows, int C, float eps,
            float keep, float take, cudaStream_t s) {
  apply_kernel<T, VEC, RES, RELU>
      <<<dim3(static_cast<unsigned>(g.gx), g.gy), dim3(g.tx, g.ty), 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(res),
          static_cast<T*>(out), static_cast<const float*>(moments),
          static_cast<const float*>(scale), static_cast<const float*>(bias),
          static_cast<const float*>(run_mean),
          static_cast<const float*>(run_var), static_cast<float*>(saved),
          static_cast<float*>(new_mean), static_cast<float*>(new_var), rows,
          C, g.groups, eps, keep, take);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, bool RELU>
int grad_sums_t(const Geometry& g, const void* grad, const void* x,
                const void* y, const void* saved, void* partial, void* dbias,
                void* dscale, long long rows, int C, cudaStream_t s) {
  grad_partial<T, VEC, RELU>
      <<<dim3(static_cast<unsigned>(g.gx), g.gy), dim3(g.tx, g.ty), 0, s>>>(
          static_cast<const T*>(grad), static_cast<const T*>(x),
          static_cast<const T*>(y), static_cast<const float*>(saved),
          static_cast<float*>(partial), rows, C, g.groups);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return finish_launch(static_cast<const float*>(partial),
                       static_cast<float*>(dbias),
                       static_cast<float*>(dscale), static_cast<int>(g.gx),
                       C, 1.f, s);
}

template <typename T, int VEC, bool RELU, bool DRES>
int dx_t(const Geometry& g, const void* grad, const void* x, const void* y,
         const void* saved, const void* scale, const void* sum_g,
         const void* sum_gx, void* dx, void* dres, long long rows, int C,
         float inv_n, cudaStream_t s) {
  dx_kernel<T, VEC, RELU, DRES>
      <<<dim3(static_cast<unsigned>(g.gx), g.gy), dim3(g.tx, g.ty), 0, s>>>(
          static_cast<const T*>(grad), static_cast<const T*>(x),
          static_cast<const T*>(y), static_cast<const float*>(saved),
          static_cast<const float*>(scale), static_cast<const float*>(sum_g),
          static_cast<const float*>(sum_gx), static_cast<T*>(dx),
          static_cast<T*>(dres), rows, C, g.groups, inv_n);
  return static_cast<int>(cudaGetLastError());
}

// Calls f(T{}, std::integral_constant<int, VEC>{}) for the dtype code
// (0 f32, 1 bf16) and the geometry's VEC; -1 for an unknown dtype.
template <typename F>
int dispatch(int dtype, int vec, F&& f) {
  if (dtype == 0) {
    switch (vec) {
      case 4: return f(float{}, std::integral_constant<int, 4>{});
      case 2: return f(float{}, std::integral_constant<int, 2>{});
      default: return f(float{}, std::integral_constant<int, 1>{});
    }
  }
  if (dtype == 1) {
    switch (vec) {
      case 8: return f(bf16{}, std::integral_constant<int, 8>{});
      case 4: return f(bf16{}, std::integral_constant<int, 4>{});
      case 2: return f(bf16{}, std::integral_constant<int, 2>{});
      default: return f(bf16{}, std::integral_constant<int, 1>{});
    }
  }
  return -1;
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// Row blocks of a (rows, C) pass in dtype (0 f32, 1 bf16): the partial
// sums buffer of bn_stats and bn_grad_sums holds that many (2, C) rows.
KFT_EXPORT int kft_bn_row_blocks(long long rows, int C, int dtype) {
  if (rows < 1 || C < 1 || (dtype != 0 && dtype != 1)) return -1;
  return static_cast<int>(geometry(rows, C, elem_bytes(dtype)).gx);
}

// x (rows, C), 16-byte aligned; partial (row blocks, 2, C) f32 scratch;
// moments (2, C) f32: the channel's sum of x and of x * x, each times
// inv_count (1 / rows, or 1 / (rows * n) for one rank of n whose moments
// a group all-reduces).
KFT_EXPORT int kft_bn_stats(const void* x, void* partial, void* moments,
                            long long rows, int C, int dtype, float inv_count,
                            void* stream) {
  if (rows < 1 || C < 1) return -1;
  const Geometry g = geometry(rows, C, elem_bytes(dtype));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, g.vec, [&](auto t, auto v) {
    using T = decltype(t);
    return stats_t<T, decltype(v)::value>(g, x, partial, moments, rows, C,
                                          inv_count, s);
  });
}

// out = relu?(bn(x) (+ residual)) from moments (2, C) (mean, mean of
// squares); saved (3, C) gets mean, var, rstd; new_mean / new_var the
// running averages keep * old + take * new. residual may be null; with
// a residual the ReLU is required (the block's last norm).
KFT_EXPORT int kft_bn_apply(const void* x, const void* residual, void* out,
                            const void* moments, const void* scale,
                            const void* bias, const void* run_mean,
                            const void* run_var, void* saved, void* new_mean,
                            void* new_var, long long rows, int C, int dtype,
                            int relu, float eps, float keep, float take,
                            void* stream) {
  if (rows < 1 || C < 1 || (residual != nullptr && !relu)) return -1;
  const Geometry g = geometry(rows, C, elem_bytes(dtype));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, g.vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int VEC = decltype(v)::value;
    if (residual != nullptr) {
      return apply_t<T, VEC, true, true>(g, x, residual, out, moments, scale,
                                         bias, run_mean, run_var, saved,
                                         new_mean, new_var, rows, C, eps,
                                         keep, take, s);
    }
    if (relu) {
      return apply_t<T, VEC, false, true>(g, x, nullptr, out, moments, scale,
                                          bias, run_mean, run_var, saved,
                                          new_mean, new_var, rows, C, eps,
                                          keep, take, s);
    }
    return apply_t<T, VEC, false, false>(g, x, nullptr, out, moments, scale,
                                         bias, run_mean, run_var, saved,
                                         new_mean, new_var, rows, C, eps,
                                         keep, take, s);
  });
}

// dbias / dscale (C) f32: sums of g' and g' * xhat, g' = g masked by
// y > 0 when y (the forward's relu output) is given, else g.
KFT_EXPORT int kft_bn_grad_sums(const void* grad, const void* x,
                                const void* y, const void* saved,
                                void* partial, void* dbias, void* dscale,
                                long long rows, int C, int dtype,
                                void* stream) {
  if (rows < 1 || C < 1) return -1;
  const Geometry g = geometry(rows, C, elem_bytes(dtype));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, g.vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int VEC = decltype(v)::value;
    if (y != nullptr) {
      return grad_sums_t<T, VEC, true>(g, grad, x, y, saved, partial, dbias,
                                       dscale, rows, C, s);
    }
    return grad_sums_t<T, VEC, false>(g, grad, x, nullptr, saved, partial,
                                      dbias, dscale, rows, C, s);
  });
}

// dx (rows, C) in x's dtype from the (all-reduced) sums over n values a
// channel, inv_n = 1/n; dres, when not null, gets g' (needs y: the
// residual sum sits under the ReLU).
KFT_EXPORT int kft_bn_dx(const void* grad, const void* x, const void* y,
                         const void* saved, const void* scale,
                         const void* sum_g, const void* sum_gx, void* dx,
                         void* dres, long long rows, int C, int dtype,
                         float inv_n, void* stream) {
  if (rows < 1 || C < 1 || (dres != nullptr && y == nullptr)) return -1;
  const Geometry g = geometry(rows, C, elem_bytes(dtype));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, g.vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int VEC = decltype(v)::value;
    if (dres != nullptr) {
      return dx_t<T, VEC, true, true>(g, grad, x, y, saved, scale, sum_g,
                                      sum_gx, dx, dres, rows, C, inv_n, s);
    }
    if (y != nullptr) {
      return dx_t<T, VEC, true, false>(g, grad, x, y, saved, scale, sum_g,
                                       sum_gx, dx, nullptr, rows, C, inv_n, s);
    }
    return dx_t<T, VEC, false, false>(g, grad, x, nullptr, saved, scale,
                                      sum_g, sum_gx, dx, nullptr, rows, C,
                                      inv_n, s);
  });
}
