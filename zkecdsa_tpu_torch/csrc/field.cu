// field_mul: c = a*b mod p, and the pair form c = a*b + d*e mod p, over
// canonical 9-limb values, one thread per output row.  field_sum: the sum
// over the leading axis of [D, R] values mod p (at the end of the file).
//
// Replaces zkecdsa_tpu/ops/pallas_field.py:183 pallas_mul (and the generic
// F32Field.mul, zkecdsa_tpu/ops/f32field.py:354).  The pair form carries
// the GK ring contraction (zkecdsa_tpu/protocol/batch_gk.py:66 _fold_ring):
// zkecdsa_tpu_torch/ops/field.py::ring_fold launches it once per ring-index
// bit.
//
// Bound on the H100: 32-bit integer multiply-adds.  A row costs two 9x9-limb
// Montgomery passes (four for the pair form), each 162 32x32->64-bit
// products, against 108 bytes moved (180 for the pair form), which puts it
// on the operations side of the card's IMAD/byte balance.  No tensor-core
// path exists for 32-bit modular products; the design keeps every
// intermediate in registers so each operand is read once.
//
// Operands are [N, K, 9] views given by (stride0, stride1) in limbs, with
// the limb axis contiguous: the ring contraction passes broadcast factors
// (stride 0) and even/odd ring rows (stride 2*9) without copying them.

#include <cuda_runtime.h>

#include "field.cuh"

struct Operand {
    const uint32_t* ptr;
    long long s0, s1;
};

template <int MOD, bool PAIR>
__global__ void field_mul_kernel(long long N, long long K, Operand a, Operand b, Operand d,
                                 Operand e, uint32_t* __restrict__ out) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= N * K) return;
    const long long n = idx / K, k = idx % K;
    const ZkModulus& M = ZK_MODS[MOD];
    Fe x, y, am, r;
    fe_load(x, a.ptr + n * a.s0 + k * a.s1);
    fe_load(y, b.ptr + n * b.s0 + k * b.s1);
    fe_to_mont(am, x, M);
    fe_mont_mul(r, am, y, M);  // a*b (standard form)
    if (PAIR) {
        Fe dm, t;
        fe_load(x, d.ptr + n * d.s0 + k * d.s1);
        fe_load(y, e.ptr + n * e.s0 + k * e.s1);
        fe_to_mont(dm, x, M);
        fe_mont_mul(t, dm, y, M);  // d*e
        fe_add(r, r, t, M);
    }
    fe_store(out + idx * ZK_NL, r);
}

template <int MOD>
static void launch(long long N, long long K, Operand a, Operand b, Operand d, Operand e,
                   uint32_t* out, cudaStream_t st) {
    const int threads = 256;
    const long long blocks = (N * K + threads - 1) / threads;
    if (d.ptr != nullptr) {
        field_mul_kernel<MOD, true><<<(unsigned)blocks, threads, 0, st>>>(N, K, a, b, d, e, out);
    } else {
        field_mul_kernel<MOD, false><<<(unsigned)blocks, threads, 0, st>>>(N, K, a, b, d, e, out);
    }
}

extern "C" int zk_field_mul(int mod, long long N, long long K,
                            const void* a, long long as0, long long as1,
                            const void* b, long long bs0, long long bs1,
                            const void* d, long long ds0, long long ds1,
                            const void* e, long long es0, long long es1,
                            void* out, void* stream) {
    if (N * K == 0) return 0;
    const Operand A{(const uint32_t*)a, as0, as1}, B{(const uint32_t*)b, bs0, bs1};
    const Operand D{(const uint32_t*)d, ds0, ds1}, E{(const uint32_t*)e, es0, es1};
    cudaStream_t st = (cudaStream_t)stream;
    uint32_t* o = (uint32_t*)out;
    switch (mod) {
        case ZK_P256_P: launch<ZK_P256_P>(N, K, A, B, D, E, o, st); break;
        case ZK_P256_N: launch<ZK_P256_N>(N, K, A, B, D, E, o, st); break;
        case ZK_TOM_P: launch<ZK_TOM_P>(N, K, A, B, D, E, o, st); break;
        case ZK_TOM_N: launch<ZK_TOM_N>(N, K, A, B, D, E, o, st); break;
        case ZK_WAR_P: launch<ZK_WAR_P>(N, K, A, B, D, E, o, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// field_sum: out[r] = sum_d x[d, r] mod p over canonical [D, R, 9] values.
//
// Replaces the fo.add folds of the sharded GK routines,
// zkecdsa_tpu/parallel/mesh.py:130-136 (sharded_gk_total: the local sum
// and the fold of the gathered partials), :204-207 (sharded_gk_dvalues)
// and :255-258 (sharded_gk_recombine).
//
// Bound on the H100: bytes.  An addition is ~30 instructions against 36
// bytes read, so the kernel only has to read each value once.  A block of
// 256 threads serves 256/lanes output rows; the `lanes` threads of a row
// (a power of two, at most 256, chosen by the wrapper from D) sum a
// strided share of the D values each, then fold their partial sums in a
// shared-memory tree.  Modular addition of canonical values is exact, so
// any order gives the plain version's integers.

template <int MOD>
__global__ void field_sum_kernel(long long D, long long R, int lanes,
                                 const uint32_t* __restrict__ x, uint32_t* __restrict__ out) {
    extern __shared__ uint32_t part[];  // [blockDim.x, ZK_NL]
    const ZkModulus& M = ZK_MODS[MOD];
    const int lane = threadIdx.x % lanes;
    const long long r = (long long)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
    Fe acc, v;
    fe_set_zero(acc);
    if (r < R) {
        for (long long d = lane; d < D; d += lanes) {
            fe_load(v, x + (d * R + r) * ZK_NL);
            fe_add(acc, acc, v, M);
        }
    }
    fe_store(part + threadIdx.x * ZK_NL, acc);
    __syncthreads();
    // lane k < h adds lane k + h's sum: the readers' slots are not written
    // in the same step, so one barrier a step suffices
    for (int h = lanes / 2; h > 0; h >>= 1) {
        if (lane < h) {
            fe_load(v, part + (threadIdx.x + h) * ZK_NL);
            fe_add(acc, acc, v, M);
            fe_store(part + threadIdx.x * ZK_NL, acc);
        }
        __syncthreads();
    }
    if (lane == 0 && r < R) fe_store(out + r * ZK_NL, acc);
}

template <int MOD>
static void launch_sum(long long D, long long R, const uint32_t* x, uint32_t* out, cudaStream_t st) {
    const int threads = 256;
    int lanes = 1;
    while (lanes < threads && lanes < D) lanes <<= 1;
    const long long rows = threads / lanes;
    const long long blocks = (R + rows - 1) / rows;
    field_sum_kernel<MOD><<<(unsigned)blocks, threads, threads * ZK_NL * sizeof(uint32_t), st>>>(
        D, R, lanes, x, out);
}

extern "C" int zk_field_sum(int mod, long long D, long long R, const void* x, void* out,
                            void* stream) {
    if (R == 0) return 0;
    const uint32_t* X = (const uint32_t*)x;
    uint32_t* o = (uint32_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (mod) {
        case ZK_P256_P: launch_sum<ZK_P256_P>(D, R, X, o, st); break;
        case ZK_P256_N: launch_sum<ZK_P256_N>(D, R, X, o, st); break;
        case ZK_TOM_P: launch_sum<ZK_TOM_P>(D, R, X, o, st); break;
        case ZK_TOM_N: launch_sum<ZK_TOM_N>(D, R, X, o, st); break;
        case ZK_WAR_P: launch_sum<ZK_WAR_P>(D, R, X, o, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
