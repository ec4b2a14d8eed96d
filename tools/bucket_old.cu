// The Pippenger bucket kernels before their redesign for the H100, kept as
// tools/torch_bucket_probe.py's "old" forms: bucket_sums one block per
// (row, window) and a thread a bucket, each term converted to Montgomery
// form in every window, every bucket started from the identity, the lists
// built by two O(B*T) scans of the digit column and thread 0's prefix;
// bucket_fold a block a row, a thread a window's running sums, thread 0's
// Horner.  Two switches on bucket_sums time the redesign's first two
// steps apart: FIRST starts each bucket from its first term, and
// CONVERT = false reads and writes the coordinates as they are (the
// shipped kernels' no-conversion rule; the fold below still converts, so
// only its group elements are compared).  Built only by the probe, in one
// translation unit with csrc/bucket.cu.

#include "curve.cuh"

namespace old_bucket {

template <int CID>
static size_t bucket_sums_smem(long long T, int B) {
    return (size_t)B * sizeof(Pt<CID>) + (size_t)(B + 2) * sizeof(int) +
           (size_t)T * (sizeof(uint16_t) + 1);
}

template <int CID, bool FIRST, bool CONVERT>
__global__ void bucket_sums_kernel(long long N, long long T, int D, int B,
                                   const uint32_t* __restrict__ points,
                                   const uint8_t* __restrict__ digits,
                                   uint32_t* __restrict__ sums) {
    extern __shared__ __align__(16) unsigned char smem[];
    Pt<CID>* piece = (Pt<CID>*)smem;             // [B] Montgomery form
    int* offs = (int*)(piece + B);               // [B + 1], then the lane split L
    uint16_t* list = (uint16_t*)(offs + B + 2);  // [T]
    uint8_t* dig = (uint8_t*)(list + T);         // [T]
    constexpr int C = CurveT<CID>::C;
    constexpr long long PT = (long long)C * ZK_NL;  // limbs per point
    const long long row = blockIdx.x % N;
    const int d = (int)(blockIdx.x / N);
    const int b = threadIdx.x;
    const uint8_t* g = digits + (row * D + d) * T;
    for (long long t = b; t < T; t += B) dig[t] = g[t];
    __syncthreads();

    int cnt = 0;
    for (long long t = 0; t < T; ++t) cnt += (dig[t] == b);
    offs[b] = cnt;
    __syncthreads();
    if (b == 0) {
        int run = 0, top = 0;
        for (int k = 0; k < B; ++k) {
            const int c = offs[k];
            offs[k] = run;
            run += c;
            if (c) top = k;
        }
        offs[B] = run;  // = T
        int L = 1;      // lanes per bucket: B/L buckets still hold every digit
        while (L < B && top < B / (2 * L)) L *= 2;
        offs[B + 1] = L;
    }
    __syncthreads();
    if (b != 0) {
        int o = offs[b];
        for (long long t = 0; t < T; ++t)
            if (dig[t] == b) list[o++] = (uint16_t)t;
    }
    __syncthreads();

    const int L = offs[B + 1], nb = B / L;
    const int c = b % nb, j = b / nb;  // lane b adds every L-th term of bucket c
    const uint32_t* pts = points + row * T * PT;
    Pt<CID> acc, P, tmp;
    pt_identity<CID>(acc);
    if (c != 0) {  // bucket 0 contributes nothing: it stays the identity
        for (int k = offs[c] + j; k < offs[c + 1]; k += L) {
            if (CONVERT) {
                pt_load<CID>(P, pts + (long long)list[k] * PT);
            } else {
                pt_load_raw<CID>(P, pts + (long long)list[k] * PT);
            }
            if (FIRST && k == offs[c] + j) {
                acc = P;
            } else {
                pt_add<CID>(tmp, acc, P);
                acc = tmp;
            }
        }
    }
    if (L > 1) {  // the same for the whole block
        piece[b] = acc;
        for (int h = L / 2; h >= 1; h /= 2) {
            __syncthreads();
            if (j < h) {
                pt_add<CID>(tmp, piece[b], piece[b + h * nb]);
                piece[b] = tmp;
            }
        }
        if (j == 0) acc = piece[b];
        else pt_identity<CID>(acc);  // bucket b >= nb is empty
    }
    if (CONVERT) {
        pt_store<CID>(sums + ((row * D + d) * (long long)B + b) * PT, acc);
    } else {
        pt_store_raw<CID>(sums + ((row * D + d) * (long long)B + b) * PT, acc);
    }
}

template <int CID>
__global__ void bucket_fold_kernel(long long N, int D, int B, int window,
                                   const uint32_t* __restrict__ sums,
                                   uint32_t* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    Pt<CID>* W = (Pt<CID>*)smem;  // [D] window sums, Montgomery form
    constexpr int C = CurveT<CID>::C;
    constexpr long long PT = (long long)C * ZK_NL;
    const long long row = blockIdx.x;
    const int d = threadIdx.x;
    Pt<CID> run, acc, S, tmp;
    pt_identity<CID>(run);
    pt_identity<CID>(acc);
    const uint32_t* s = sums + (row * D + d) * B * PT;
    for (int b = B - 1; b >= 1; --b) {
        pt_load<CID>(S, s + b * PT);
        pt_add<CID>(tmp, run, S);
        run = tmp;
        pt_add<CID>(tmp, acc, run);
        acc = tmp;
    }
    W[d] = acc;
    __syncthreads();
    if (d != 0) return;
    pt_identity<CID>(acc);
    for (int k = 0; k < D; ++k) {
#pragma unroll 1
        for (int j = 0; j < window; ++j) {
            pt_dbl<CID>(tmp, acc);
            acc = tmp;
        }
        pt_add<CID>(tmp, acc, W[k]);
        acc = tmp;
    }
    pt_store<CID>(out + row * PT, acc);
}

}  // namespace old_bucket

extern "C" int probe_old_bucket_sums(int curve, int first, int convert, long long N, long long T,
                                     int D, int B, const void* points, const void* digits,
                                     void* sums, void* stream) {
    if (N * D == 0) return 0;
    if (B < 2 || B > 256 || T >= 65536) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int err = 0;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        const size_t smem = old_bucket::bucket_sums_smem<CID>(T, B);
        auto kern = first ? (convert ? old_bucket::bucket_sums_kernel<CID, true, true> : old_bucket::bucket_sums_kernel<CID, true, false>)
                          : (convert ? old_bucket::bucket_sums_kernel<CID, false, true> : old_bucket::bucket_sums_kernel<CID, false, false>);
        if (smem > 48 * 1024)
            err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err) return;
        kern<<<(unsigned)(N * D), B, smem, st>>>(N, T, D, B, (const uint32_t*)points,
                                                 (const uint8_t*)digits, (uint32_t*)sums);
    });
    if (bad) return bad;
    return err ? err : (int)cudaGetLastError();
}

extern "C" int probe_old_bucket_fold(int curve, long long N, int D, int B, int window,
                                     const void* sums, void* out, void* stream) {
    if (N == 0) return 0;
    if (D < 1 || D > 1024 || B < 2) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        const size_t smem = (size_t)D * sizeof(Pt<CID>);
        old_bucket::bucket_fold_kernel<CID><<<(unsigned)N, D, smem, st>>>(N, D, B, window, (const uint32_t*)sums,
                                                            (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}
