// field_mul: c = a*b mod p, and the pair form c = a*b + d*e mod p, over
// canonical 9-limb values, one thread per output row.
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
