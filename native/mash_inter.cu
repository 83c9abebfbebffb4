// Mash sketch intersection counts on the GPU, called from JAX through
// the XLA FFI (dipper_tpu/distance/mash_gpu.py).
//
// One thread per (query, bank row) pair runs the reference's serial
// two-pointer merge-walk (src/mash.cu:426-450) over rank-compressed
// int32 sketches: B (query) elements that are <= the current A (bank)
// element are consumed first; a B element equal to it is `inter` (all
// equal B copies match: the asymmetric multiset rule), every other
// consumed element adds to `uni`, and the walk stops once `uni` reaches
// sketch_size. Counts equal distance/mash.py:_merged_inter_count
// bitwise, pad keys included.
//
// A block stages a tile of bank rows and a tile of queries in shared
// memory with coalesced loads, so each row is read from device memory
// once per tile and serves every pair of the tile. Rows are stored with
// stride m + 1 and an INT_MAX sentinel in the last slot, so an
// exhausted sketch is never read past its end.
//
// Leading dimensions are a batch: bank [..., N, M] x query [..., Q, M]
// -> out [..., Q, N] (jax.vmap reaches the kernel as one launch).

#include <climits>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxBankTile = 32;   // bank rows per block
constexpr int kMaxQueryTile = 16;  // queries per block
constexpr int kSmemLimit = 227 * 1024;

__global__ void MashInterKernel(const int32_t* __restrict__ bank,
                                const int32_t* __restrict__ query,
                                int32_t* __restrict__ out, int64_t n,
                                int64_t q, int m, int sketch_size, int tn,
                                int tq) {
  extern __shared__ int32_t smem[];
  const int stride = m + 1;
  int32_t* sb = smem;               // [tn][m + 1]
  int32_t* sq = smem + tn * stride;  // [tq][m + 1]
  const int64_t g = blockIdx.z;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * tn;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * tq;
  bank += g * n * m;
  query += g * q * m;
  out += g * q * n;

  for (int r = 0; r < tn; ++r) {
    const int64_t row = n0 + r;
    for (int c = threadIdx.x; c < m; c += blockDim.x)
      sb[r * stride + c] = row < n ? bank[row * m + c] : INT_MAX;
  }
  for (int r = 0; r < tq; ++r) {
    const int64_t row = q0 + r;
    for (int c = threadIdx.x; c < m; c += blockDim.x)
      sq[r * stride + c] = row < q ? query[row * m + c] : INT_MAX;
  }
  for (int r = threadIdx.x; r < tn + tq; r += blockDim.x)
    smem[r * stride + m] = INT_MAX;
  __syncthreads();

  const int ti = threadIdx.x % tn;
  const int qi = threadIdx.x / tn;
  const int64_t row = n0 + ti;
  const int64_t qrow = q0 + qi;
  if (row >= n || qrow >= q) return;
  const int32_t* a = sb + ti * stride;
  const int32_t* b = sq + qi * stride;

  // Each step consumes one element: the next B if it is <= the next A,
  // else the next A. Only one shared-memory load per step.
  int ai = 0, bi = 0, uni = 0, inter = 0;
  int av = a[0], bv = b[0];
  while (uni < sketch_size) {
    const bool take_b = bv <= av;
    const bool match = take_b && bv == av;
    inter += match;
    uni += !match;
    ai += !take_b;
    bi += take_b;
    const int v = take_b ? b[bi] : a[ai];
    av = take_b ? av : v;
    bv = take_b ? v : bv;
  }
  out[qrow * n + row] = inter;
}

ffi::Error MashInterImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> bank,
                         ffi::Buffer<ffi::S32> query,
                         ffi::ResultBuffer<ffi::S32> out,
                         int64_t sketch_size) {
  auto bd = bank.dimensions();
  auto qd = query.dimensions();
  if (bd.size() < 2 || bd.size() != qd.size())
    return ffi::Error::InvalidArgument(
        "mash_inter: bank [..., N, M] and query [..., Q, M] need the same "
        "rank, at least 2");
  const int64_t m = bd.back();
  const int64_t n = bd[bd.size() - 2];
  const int64_t q = qd[qd.size() - 2];
  if (qd.back() != m)
    return ffi::Error::InvalidArgument("mash_inter: sketch widths differ");
  int64_t g = 1;
  for (size_t i = 0; i + 2 < bd.size(); ++i) {
    if (bd[i] != qd[i])
      return ffi::Error::InvalidArgument("mash_inter: batch dims differ");
    g *= bd[i];
  }
  if (sketch_size < 1 || sketch_size > m)
    return ffi::Error::InvalidArgument(
        "mash_inter: sketch_size must be in [1, M]");
  if (g == 0 || n == 0 || q == 0) return ffi::Error::Success();

  int tn = kMaxBankTile;
  int tq = static_cast<int>(q < kMaxQueryTile ? q : kMaxQueryTile);
  auto smem_of = [&](int a, int b) {
    return static_cast<int64_t>(a + b) * (m + 1) * sizeof(int32_t);
  };
  while (smem_of(tn, tq) > kSmemLimit && (tn > 1 || tq > 1)) {
    if (tq >= tn && tq > 1) tq /= 2; else tn /= 2;
  }
  const int64_t smem = smem_of(tn, tq);
  if (smem > kSmemLimit)
    return ffi::Error::InvalidArgument(
        "mash_inter: sketch width " + std::to_string(m) +
        " does not fit in shared memory");
  const int64_t gx = (n + tn - 1) / tn;
  const int64_t gy = (q + tq - 1) / tq;
  if (gx > INT_MAX || gy > 65535 || g > 65535)
    return ffi::Error::InvalidArgument("mash_inter: grid too large");

  cudaError_t err = cudaFuncSetAttribute(
      MashInterKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("mash_inter: ") +
                                cudaGetErrorString(err));
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
            static_cast<unsigned>(g));
  MashInterKernel<<<grid, tn * tq, smem, stream>>>(
      bank.typed_data(), query.typed_data(), out->typed_data(), n, q,
      static_cast<int>(m), static_cast<int>(sketch_size), tn, tq);
  err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("mash_inter: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(DipperMashInter, MashInterImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int64_t>("sketch_size"));
