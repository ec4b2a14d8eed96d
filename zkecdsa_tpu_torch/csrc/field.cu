// field_mul: c = a*b mod p, and the pair form c = a*b + d*e mod p, over
// canonical 9-limb values, one thread per output row.  ring_fold: the GK
// ring contraction in one launch.  field_sum: the sum over the leading
// axis of [D, R] values mod p (at the end of the file).
//
// field_mul replaces zkecdsa_tpu/ops/pallas_field.py:183 pallas_mul (and
// the generic F32Field.mul, zkecdsa_tpu/ops/f32field.py:354).  Bound on
// the H100: 32-bit integer multiply-adds.  A row costs two 9x9-limb
// Montgomery passes (four for the pair form), each 162 32x32->64-bit
// products, against 108 bytes moved (180 for the pair form), which puts it
// on the operations side of the card's IMAD/byte balance.  No tensor-core
// path exists for 32-bit modular products; the design keeps every
// intermediate in registers so each operand is read once.  Operands are
// [N, K, 9] views given by (stride0, stride1) in limbs, with the limb axis
// contiguous, so broadcast operands (stride 0) cost no copy.  The main
// path no longer calls it (ring_fold below took its one use there); the
// mesh's ring-sharded GK routines do.
//
// ring_fold replaces zkecdsa_tpu/protocol/batch_gk.py:66 _fold_ring:
// out[r] = sum_i v_i * prod_j (f[r, j] if bit_j(i) else xf[r, j]) mod the
// Tom-256 order, values [2^n, 9], f and xf [N, n, 9].  Its least work is
// 2^n - 1 pair products a row (2 products and an add each).  As n
// pair-form field_mul launches a call, each level would go to HBM and
// back, both factors of a row would be converted to Montgomery form on
// every row, and at the verifier's [256, 4096] the launch rate would set
// the time (chip_smoke.py times those launches beside this kernel).
// Here one block takes one row: its 2n factors go to Montgomery form
// once, into shared memory, so each output costs exactly 2 products and 1
// add (the values stay in standard form: Montgomery factor times standard
// value is standard).  The
// contraction is a multilinear form, so the bits may be folded in any
// order: thread t of the block's 2^b (b = min(n, 8)) takes the values
// t + 2^b m, m < 2^(n-b) (a warp reads neighbouring values at each step,
// from L2: 147 KB at ring 2^12 for every block), and folds the bits of m
// (index bits b..n-1) as they stream in, a stack of partial sums a level
// (local memory, L1-resident); the block then folds the 2^b partials
// through index bits 0..b-1 in shared memory, a barrier a level.  No level
// goes to HBM.  One block a row fills the card at the main path's N (256
// and 3072 rows); a small N runs on a few SMs.

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

// ring_fold: one block a row (see the note at the top).
#define RF_MAXN 32
#define RF_MAXB 8

__device__ __forceinline__ void rf_pair(Fe r, const Fe even, const Fe odd, const uint32_t* fac,
                                        int j, const ZkModulus& M) {
    Fe a, b;
    fe_mont_mul(a, fac + (2 * j) * ZK_NL, even, M);  // xf_j * T[2k]
    fe_mont_mul(b, fac + (2 * j + 1) * ZK_NL, odd, M);  // f_j * T[2k+1]
    fe_add(r, a, b, M);
}

__global__ void __launch_bounds__(1 << RF_MAXB) ring_fold_kernel(
    int n, int b, const uint32_t* __restrict__ values, const uint32_t* __restrict__ f,
    const uint32_t* __restrict__ xf, uint32_t* __restrict__ out) {
    __shared__ uint32_t fac[2 * RF_MAXN * ZK_NL];  // xf_j, f_j in Montgomery form
    __shared__ uint32_t part[(1 << RF_MAXB) * ZK_NL];
    const ZkModulus& M = ZK_MODS[ZK_TOM_N];
    const long long row = blockIdx.x;
    const int t = threadIdx.x;
    for (int s = t; s < 2 * n; s += blockDim.x) {
        Fe v, m;
        fe_load(v, ((s & 1) ? f : xf) + (row * n + (s >> 1)) * ZK_NL);
        fe_to_mont(m, v, M);
        fe_store(fac + s * ZK_NL, m);
    }
    __syncthreads();
    // index bits b..n-1 in the thread: the values t + 2^b m, m streaming
    const int k = n - b;
    Fe stack[RF_MAXN], cur;
#pragma unroll 1
    for (long long m = 0; m < (1LL << k); ++m) {
        fe_load(cur, values + (t + (m << b)) * ZK_NL);
        int l = 0;
#pragma unroll 1
        for (; (m >> l) & 1; ++l) rf_pair(cur, stack[l], cur, fac, b + l, M);
        if (l < k) fe_copy(stack[l], cur);
    }
    fe_store(part + t * ZK_NL, cur);
    __syncthreads();
    // index bits 0..b-1 across the block: at level l, thread s pairs slot
    // s 2^(l+1) with its neighbour 2^l on; the active threads are the
    // first ones, so whole warps idle instead of every warp running with
    // a few lanes
    for (int l = 0; l < b; ++l) {
        if (t < (1 << (b - 1 - l))) {
            const int s = t << (l + 1);
            Fe e, o;
            fe_load(e, part + s * ZK_NL);
            fe_load(o, part + (s + (1 << l)) * ZK_NL);
            rf_pair(e, e, o, fac, l, M);
            fe_store(part + s * ZK_NL, e);
        }
        __syncthreads();
    }
    if (t == 0) {
        Fe r;
        fe_load(r, part);
        fe_store(out + row * ZK_NL, r);
    }
}

extern "C" int zk_ring_fold(int n, long long N, const void* values, const void* f, const void* xf,
                            void* out, void* stream) {
    if (n < 0 || n > RF_MAXN) return (int)cudaErrorInvalidValue;
    if (N == 0) return 0;
    const int b = n < RF_MAXB ? n : RF_MAXB;
    ring_fold_kernel<<<(unsigned)N, 1 << b, 0, (cudaStream_t)stream>>>(
        n, b, (const uint32_t*)values, (const uint32_t*)f, (const uint32_t*)xf, (uint32_t*)out);
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
