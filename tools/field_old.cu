// field_mul and field_sum before their redesign for the H100, kept as
// tools/torch_field_probe.py's "old" forms: one thread a row in 256-thread
// blocks, a 64-bit division of the flat index, every product as two 9-limb
// Montgomery products (fe_to_mont, then fe_mont_mul; four and an add for
// the pair form); field_sum lanes a row (a power of two up to 256, from D)
// folding their partial sums in a shared-memory tree, a barrier a level.
// Built only by the probe, in one translation unit with csrc/field.cu.

#include <cuda_runtime.h>

#include "field.cuh"

namespace old_field {

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

}  // namespace old_field

extern "C" int probe_old_field_mul(int mod, long long N, long long K,
                            const void* a, long long as0, long long as1,
                            const void* b, long long bs0, long long bs1,
                            const void* d, long long ds0, long long ds1,
                            const void* e, long long es0, long long es1,
                            void* out, void* stream) {
    if (N * K == 0) return 0;
    const old_field::Operand A{(const uint32_t*)a, as0, as1}, B{(const uint32_t*)b, bs0, bs1};
    const old_field::Operand D{(const uint32_t*)d, ds0, ds1}, E{(const uint32_t*)e, es0, es1};
    cudaStream_t st = (cudaStream_t)stream;
    uint32_t* o = (uint32_t*)out;
    switch (mod) {
        case ZK_P256_P: old_field::launch<ZK_P256_P>(N, K, A, B, D, E, o, st); break;
        case ZK_P256_N: old_field::launch<ZK_P256_N>(N, K, A, B, D, E, o, st); break;
        case ZK_TOM_P: old_field::launch<ZK_TOM_P>(N, K, A, B, D, E, o, st); break;
        case ZK_TOM_N: old_field::launch<ZK_TOM_N>(N, K, A, B, D, E, o, st); break;
        case ZK_WAR_P: old_field::launch<ZK_WAR_P>(N, K, A, B, D, E, o, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}


extern "C" int probe_old_field_sum(int mod, long long D, long long R, const void* x, void* out,
                            void* stream) {
    if (R == 0) return 0;
    const uint32_t* X = (const uint32_t*)x;
    uint32_t* o = (uint32_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (mod) {
        case ZK_P256_P: old_field::launch_sum<ZK_P256_P>(D, R, X, o, st); break;
        case ZK_P256_N: old_field::launch_sum<ZK_P256_N>(D, R, X, o, st); break;
        case ZK_TOM_P: old_field::launch_sum<ZK_TOM_P>(D, R, X, o, st); break;
        case ZK_TOM_N: old_field::launch_sum<ZK_TOM_N>(D, R, X, o, st); break;
        case ZK_WAR_P: old_field::launch_sum<ZK_WAR_P>(D, R, X, o, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
