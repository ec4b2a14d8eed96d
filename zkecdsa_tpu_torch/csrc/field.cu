// field_mul: c = a*b mod p, the pair form c = a*b + d*e mod p, and the
// chain form c = v * prod_j f_j mod p, over canonical 9-limb values, one
// thread a row.  ring_fold: the GK ring contraction in one launch.
// field_sum: the sum over the leading axis of [D, R] values mod p (at the
// end of the file).
//
// field_mul replaces zkecdsa_tpu/ops/pallas_field.py:183 pallas_mul (and
// the generic F32Field.mul, zkecdsa_tpu/ops/f32field.py:354); its chain
// form replaces the fo.mul loop of zkecdsa_tpu/parallel/mesh.py:122-125
// (sharded_gk_total: the product of a ring element's n factors, then its
// value), which ran as n launches, each through HBM.  Its callers are the
// mesh's ring-sharded GK routines, all on the Tom-256 order, which is the
// P-256 prime: [1536] and [128] rows for the high index bits' factors, a
// chain of 12 factors over [2048] rows.  At those sizes a launch's fixed
// cost is most of its device time, so the design cuts each row's chain
// and spreads the rows: the P-256 prime takes the Solinas product
// (field.cuh fe_mul_p256: 64 wide products and ~110 additions in standard
// form, where the parent ran two 9x9-limb Montgomery products, a
// conversion in and the product); the other moduli keep CIOS (CiosOp:
// two products, three for the pair form); the rows go one a thread in
// blocks of `threads` (32-256, chosen by the wrapper from the row count,
// ops/field.py field_plan, so that [128]-[2048] rows spread over the
// SMs); a 2-D grid (x over the K axis, y over N) replaces the flat index's
// 64-bit division; the chain keeps its running product in registers and
// loads the next factor while it multiplies.  Bound on the H100: bytes at
// every caller shape (108 bytes a product, 180 for the pair form, 36 a
// link of a chain), far under the launch floor at the callers' sizes.
// Operands are [N, K, 9] views given by (stride0, stride1) in limbs, with
// the limb axis contiguous, so broadcast operands (stride 0) cost no copy.
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

#include <type_traits>

#include "field.cuh"

// The products of a modulus.  CiosOp: Montgomery products (a is converted,
// a*R times b is a*b in standard form); the pair form as a*b/R + d*e/R,
// then one conversion: three products.  SolinasOp: the P-256 prime
// (field.cuh fe_mul_p256).
template <int MOD>
struct CiosOp {
    static __device__ __forceinline__ void mul(Fe r, const Fe a, const Fe b) {
        const ZkModulus& M = ZK_MODS[MOD];
        Fe am;
        fe_to_mont(am, a, M);
        fe_mont_mul(r, am, b, M);
    }
    static __device__ __forceinline__ void mul2(Fe r, const Fe a, const Fe b, const Fe d, const Fe e) {
        const ZkModulus& M = ZK_MODS[MOD];
        Fe t, u;
        fe_mont_mul(t, a, b, M);
        fe_mont_mul(u, d, e, M);
        fe_add(t, t, u, M);
        fe_to_mont(r, t, M);
    }
};

struct SolinasOp {
    static __device__ __forceinline__ void mul(Fe r, const Fe a, const Fe b) { fe_mul_p256(r, a, b); }
    // each product reduced, then a modular add: 10% less device time at
    // [65536] than the two 512-bit products summed and reduced once
    // (tools/torch_field_probe.py, PERF.md)
    static __device__ __forceinline__ void mul2(Fe r, const Fe a, const Fe b, const Fe d, const Fe e) {
        Fe t, u;
        fe_mul_p256(t, a, b);
        fe_mul_p256(u, d, e);
        fe_add(r, t, u, ZK_MODS[ZK_P256_P]);
    }
};

template <int MOD>
using OpFor = std::conditional_t<MOD == ZK_P256_P || MOD == ZK_TOM_N, SolinasOp, CiosOp<MOD>>;

struct Operand {
    const uint32_t* ptr;
    long long s0, s1;
};

// blockIdx.x over K, blockIdx.y (and its stride, past 65535 rows) over N
template <class Op, bool PAIR>
__global__ void field_mul_kernel(long long N, long long K, Operand a, Operand b, Operand d,
                                 Operand e, uint32_t* __restrict__ out) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    for (long long n = blockIdx.y; n < N; n += gridDim.y) {
        Fe x, y, r;
        fe_load(x, a.ptr + n * a.s0 + k * a.s1);
        fe_load(y, b.ptr + n * b.s0 + k * b.s1);
        if (PAIR) {
            Fe u, v;
            fe_load(u, d.ptr + n * d.s0 + k * d.s1);
            fe_load(v, e.ptr + n * e.s0 + k * e.s1);
            Op::mul2(r, x, y, u, v);
        } else {
            Op::mul(r, x, y);
        }
        fe_store(out + (n * K + k) * ZK_NL, r);
    }
}

template <class Op>
static void launch_mul(long long N, long long K, Operand a, Operand b, Operand d, Operand e,
                       uint32_t* out, int threads, cudaStream_t st) {
    const dim3 grid((unsigned)((K + threads - 1) / threads), (unsigned)(N < 65535 ? N : 65535));
    if (d.ptr != nullptr) {
        field_mul_kernel<Op, true><<<grid, threads, 0, st>>>(N, K, a, b, d, e, out);
    } else {
        field_mul_kernel<Op, false><<<grid, threads, 0, st>>>(N, K, a, b, d, e, out);
    }
}

static bool valid_threads(int threads) {
    return threads >= 32 && threads <= 1024 && (threads & (threads - 1)) == 0;
}

extern "C" int zk_field_mul(int mod, long long N, long long K,
                            const void* a, long long as0, long long as1,
                            const void* b, long long bs0, long long bs1,
                            const void* d, long long ds0, long long ds1,
                            const void* e, long long es0, long long es1,
                            void* out, int threads, void* stream) {
    if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
    if (N * K == 0) return 0;
    const Operand A{(const uint32_t*)a, as0, as1}, B{(const uint32_t*)b, bs0, bs1};
    const Operand D{(const uint32_t*)d, ds0, ds1}, E{(const uint32_t*)e, es0, es1};
    cudaStream_t st = (cudaStream_t)stream;
    uint32_t* o = (uint32_t*)out;
    switch (mod) {
        case ZK_P256_P: launch_mul<OpFor<ZK_P256_P>>(N, K, A, B, D, E, o, threads, st); break;
        case ZK_P256_N: launch_mul<OpFor<ZK_P256_N>>(N, K, A, B, D, E, o, threads, st); break;
        case ZK_TOM_P: launch_mul<OpFor<ZK_TOM_P>>(N, K, A, B, D, E, o, threads, st); break;
        case ZK_TOM_N: launch_mul<OpFor<ZK_TOM_N>>(N, K, A, B, D, E, o, threads, st); break;
        case ZK_WAR_P: launch_mul<OpFor<ZK_WAR_P>>(N, K, A, B, D, E, o, threads, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The chain form: out[r] = values[r] * prod_j factors[r, j], factors
// [R, n, 9] and values [R, 9] contiguous, a thread a row.  The products
// run from the values row through the factors in order (canonical
// integers: any order gives the same result); factor j + 1 is loaded
// while factor j's product runs.
template <class Op>
__global__ void field_chain_kernel(long long R, int n, const uint32_t* __restrict__ values,
                                   const uint32_t* __restrict__ factors, uint32_t* __restrict__ out) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const uint32_t* f = factors + r * n * ZK_NL;
    Fe acc, cur;
    fe_load(acc, values + r * ZK_NL);
    if (n > 0) fe_load(cur, f);
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
        Fe fj;
        fe_copy(fj, cur);
        if (j + 1 < n) fe_load(cur, f + (j + 1) * ZK_NL);
        Op::mul(acc, acc, fj);
    }
    fe_store(out + r * ZK_NL, acc);
}

extern "C" int zk_field_mul_chain(int mod, long long R, int n, const void* values,
                                  const void* factors, void* out, int threads, void* stream) {
    if (!valid_threads(threads) || n < 0) return (int)cudaErrorInvalidValue;
    if (R == 0) return 0;
    const unsigned blocks = (unsigned)((R + threads - 1) / threads);
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t *v = (const uint32_t*)values, *f = (const uint32_t*)factors;
    uint32_t* o = (uint32_t*)out;
    switch (mod) {
        case ZK_P256_P: field_chain_kernel<OpFor<ZK_P256_P>><<<blocks, threads, 0, st>>>(R, n, v, f, o); break;
        case ZK_P256_N: field_chain_kernel<OpFor<ZK_P256_N>><<<blocks, threads, 0, st>>>(R, n, v, f, o); break;
        case ZK_TOM_P: field_chain_kernel<OpFor<ZK_TOM_P>><<<blocks, threads, 0, st>>>(R, n, v, f, o); break;
        case ZK_TOM_N: field_chain_kernel<OpFor<ZK_TOM_N>><<<blocks, threads, 0, st>>>(R, n, v, f, o); break;
        case ZK_WAR_P: field_chain_kernel<OpFor<ZK_WAR_P>><<<blocks, threads, 0, st>>>(R, n, v, f, o); break;
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
// and :255-258 (sharded_gk_recombine).  Their calls: [2, 1536], [2, 128]
// and [2, 1] (the gathered partials of two ring ranks) and [2048, 1]
// (sharded_gk_total's local sum).
//
// Bound on the H100: bytes (an addition is ~20 instructions against 36
// bytes read), far under the launch floor at those sizes, so the design
// cuts the steps a call waits on.  Small D (at most 8, the ring axis): a
// thread a row adds its D values in registers, no shared memory, no
// barrier (field_sum_rows_kernel; blocks of `threads` by the wrapper's
// plan).  Large D: a block of `threads` lanes a row, each lane summing a
// strided share, then a warp-shuffle tree (5 levels) and one step across
// the warps through shared memory (field_sum_block_kernel).  For the
// P-256 prime the sums stay unreduced in 9 words (8 and a carry word: up
// to 2^32 terms fit) and are reduced once at the end by two Solinas folds
// and a masked subtraction (P256Acc); the other moduli add modulo p at
// every step (ModAcc).  Modular addition of canonical values is exact, so
// any order gives the plain version's integers.

template <int MOD>
struct ModAcc {
    Fe v;
    __device__ __forceinline__ void zero() { fe_set_zero(v); }
    __device__ __forceinline__ void add(const Fe x) { fe_add(v, v, x, ZK_MODS[MOD]); }
    __device__ __forceinline__ void get(Fe r) const { fe_copy(r, v); }
};

struct P256Acc {
    uint32_t v[ZK_NL];  // the unreduced sum: words 0..7 and a carry word
    __device__ __forceinline__ void zero() { fe_set_zero(v); }
    __device__ __forceinline__ void add(const Fe x) {
        p256_add8(v, x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7]);  // x[8] = 0: x < p
    }
    __device__ __forceinline__ void get(Fe r) const {
        uint32_t t[ZK_NL];
        fe_copy(t, v);
        p256_fold(t);  // < 2^257
        p256_fold(t);  // < 2^256 < 2p
        fe_reduce_once(r, t, 0u, ZK_MODS[ZK_P256_P]);
    }
};

template <int MOD>
using AccFor = std::conditional_t<MOD == ZK_P256_P || MOD == ZK_TOM_N, P256Acc, ModAcc<MOD>>;

template <class Acc>
__global__ void field_sum_rows_kernel(long long D, long long R, const uint32_t* __restrict__ x,
                                      uint32_t* __restrict__ out) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    Acc acc;
    acc.zero();
    Fe v;
#pragma unroll 4
    for (long long d = 0; d < D; ++d) {
        fe_load(v, x + (d * R + r) * ZK_NL);
        acc.add(v);
    }
    acc.get(v);
    fe_store(out + r * ZK_NL, v);
}

// a += b, for the warp's tree
template <int MOD>
__device__ __forceinline__ void merge(ModAcc<MOD>& a, const ModAcc<MOD>& b) { a.add(b.v); }

__device__ __forceinline__ void merge(P256Acc& a, const P256Acc& b) {
    uint32_t* t = a.v;
    asm("add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, %8, %17;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8])
        : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]),
          "r"(b.v[6]), "r"(b.v[7]), "r"(b.v[8]));
}

// the word-by-word sum of the accumulators of lanes l and l + 16, l + 8,
// ... l + 1: lane 0 ends with the warp's sum (as an addend: an unreduced
// P-256 sum is added word by word with its carry word)
template <class Acc>
__device__ __forceinline__ void warp_fold(Acc& acc) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        Acc o;
#pragma unroll
        for (int i = 0; i < ZK_NL; ++i) o.v[i] = __shfl_down_sync(0xffffffffu, acc.v[i], off);
        merge(acc, o);
    }
}

template <class Acc>
__global__ void __launch_bounds__(1024) field_sum_block_kernel(
    long long D, long long R, const uint32_t* __restrict__ x, uint32_t* __restrict__ out) {
    __shared__ uint32_t part[32 * ZK_NL];  // a warp's sum each
    const long long r = blockIdx.x;
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31, warps = blockDim.x >> 5;
    Acc acc;
    acc.zero();
    Fe v;
#pragma unroll 4
    for (long long d = t; d < D; d += blockDim.x) {
        fe_load(v, x + (d * R + r) * ZK_NL);
        acc.add(v);
    }
    warp_fold(acc);
    if (lane == 0) fe_store(part + warp * ZK_NL, acc.v);
    __syncthreads();
    if (warp == 0) {
        if (lane < warps) {
            fe_load(acc.v, part + lane * ZK_NL);
        } else {
            acc.zero();
        }
        warp_fold(acc);
        if (lane == 0) {
            acc.get(v);
            fe_store(out + r * ZK_NL, v);
        }
    }
}

template <int MOD>
static void launch_sum(long long D, long long R, const uint32_t* x, uint32_t* out, int lanes,
                       int threads, cudaStream_t st) {
    if (lanes == 1) {
        field_sum_rows_kernel<AccFor<MOD>><<<(unsigned)((R + threads - 1) / threads), threads, 0, st>>>(
            D, R, x, out);
    } else {
        field_sum_block_kernel<AccFor<MOD>><<<(unsigned)R, lanes, 0, st>>>(D, R, x, out);
    }
}

// lanes: 1 (a thread a row, blocks of `threads`) or a block of `lanes`
// threads a row (a multiple of 32, at most 1024; `threads` unused)
extern "C" int zk_field_sum(int mod, long long D, long long R, const void* x, void* out, int lanes,
                            int threads, void* stream) {
    if (lanes == 1 ? !valid_threads(threads) : (lanes < 32 || lanes > 1024 || lanes % 32 != 0)) {
        return (int)cudaErrorInvalidValue;
    }
    if (R == 0) return 0;
    const uint32_t* X = (const uint32_t*)x;
    uint32_t* o = (uint32_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (mod) {
        case ZK_P256_P: launch_sum<ZK_P256_P>(D, R, X, o, lanes, threads, st); break;
        case ZK_P256_N: launch_sum<ZK_P256_N>(D, R, X, o, lanes, threads, st); break;
        case ZK_TOM_P: launch_sum<ZK_TOM_P>(D, R, X, o, lanes, threads, st); break;
        case ZK_TOM_N: launch_sum<ZK_TOM_N>(D, R, X, o, lanes, threads, st); break;
        case ZK_WAR_P: launch_sum<ZK_WAR_P>(D, R, X, o, lanes, threads, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// zk_noop: an empty kernel, launched through the same ctypes path as the
// kernels above, so that a trace of it gives the device time of a launch
// that does no work (the launch floor beside a small call's device time).
__global__ void noop_kernel() {}

extern "C" int zk_noop(int blocks, int threads, void* stream) {
    noop_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
