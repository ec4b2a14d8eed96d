// The forms of csrc/field.cu's field_mul that the shipped kernel does not
// hold, for tools/torch_field_probe.py: the P-256 prime on the Montgomery
// products (CiosOp<ZK_P256_P>, the other moduli's form) in the shipped
// geometry, plain, pair and chain; and the pair form with the two 512-bit
// products summed and reduced once (the shipped one reduces each product
// and adds: 10% less device time at [65536], PERF.md).  Built
// only by the probe, in one translation unit with csrc/field.cu.

// The pair form summed once: the two 512-bit products added (carry word
// k: three chains, each within one asm statement's operand count), then
// one reduction whose sum also takes k (2^512 mod p), under a mask: with
// it the reduction's top word is at most 12 and one fold still leaves
// t < 2p.
__device__ __forceinline__ void summed_reduce(Fe r, const uint32_t* c, uint32_t k) {
    uint32_t t[9] = {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], 0u};
    p256_add8(t, 0u, 0u, 0u, c[11], c[12], c[13], c[14], c[15]);
    p256_add8(t, 0u, 0u, 0u, c[11], c[12], c[13], c[14], c[15]);
    p256_add8(t, 0u, 0u, 0u, c[12], c[13], c[14], c[15], 0u);
    p256_add8(t, 0u, 0u, 0u, c[12], c[13], c[14], c[15], 0u);
    p256_add8(t, c[8], c[9], c[10], 0u, 0u, 0u, c[14], c[15]);
    p256_add8(t, c[9], c[10], c[11], c[13], c[14], c[15], c[13], c[8]);
    p256_sub8(t, c[11], c[12], c[13], 0u, 0u, 0u, c[8], c[10]);
    p256_sub8(t, c[12], c[13], c[14], c[15], 0u, 0u, c[9], c[11]);
    p256_sub8(t, c[13], c[14], c[15], c[8], c[9], c[10], 0u, c[12]);
    p256_sub8(t, c[14], c[15], 0u, c[9], c[10], c[11], 0u, c[13]);
    asm("add.cc.u32 %0, %0, 0xfffffffb;\n\t"
        "addc.cc.u32 %1, %1, 0xffffffff;\n\t"
        "addc.cc.u32 %2, %2, 0xffffffff;\n\t"
        "addc.cc.u32 %3, %3, 0x00000004;\n\t"
        "addc.cc.u32 %4, %4, 0x00000000;\n\t"
        "addc.cc.u32 %5, %5, 0x00000000;\n\t"
        "addc.cc.u32 %6, %6, 0x00000005;\n\t"
        "addc.cc.u32 %7, %7, 0xfffffffb;\n\t"
        "addc.u32 %8, %8, 0x00000004;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8]));
    const uint32_t m = 0u - k;  // + k (2^512 mod p)
    p256_add8(t, 3u & m, 0u, m, 0xfffffffbu & m, 0xfffffffeu & m, m, 0xfffffffdu & m, 4u & m);
    p256_fold(t);
    fe_reduce_once(r, t, 0u, ZK_MODS[ZK_P256_P]);
}

struct SolinasSummedOnce {
    static __device__ __forceinline__ void mul(Fe r, const Fe a, const Fe b) { fe_mul_p256(r, a, b); }
    static __device__ __forceinline__ void mul2(Fe r, const Fe a, const Fe b, const Fe d, const Fe e) {
        uint32_t c[16], g[16], k, k0;
        p256_wide_mul(c, a, b);
        p256_wide_mul(g, d, e);
        asm("add.cc.u32 %0, %0, %9;\n\t"
            "addc.cc.u32 %1, %1, %10;\n\t"
            "addc.cc.u32 %2, %2, %11;\n\t"
            "addc.cc.u32 %3, %3, %12;\n\t"
            "addc.cc.u32 %4, %4, %13;\n\t"
            "addc.cc.u32 %5, %5, %14;\n\t"
            "addc.cc.u32 %6, %6, %15;\n\t"
            "addc.cc.u32 %7, %7, %16;\n\t"
            "addc.u32 %8, 0, 0;"
            : "+r"(c[8]), "+r"(c[9]), "+r"(c[10]), "+r"(c[11]), "+r"(c[12]), "+r"(c[13]),
              "+r"(c[14]), "+r"(c[15]), "=r"(k)
            : "r"(g[8]), "r"(g[9]), "r"(g[10]), "r"(g[11]), "r"(g[12]), "r"(g[13]), "r"(g[14]),
              "r"(g[15]));
        asm("add.cc.u32 %0, %0, %9;\n\t"
            "addc.cc.u32 %1, %1, %10;\n\t"
            "addc.cc.u32 %2, %2, %11;\n\t"
            "addc.cc.u32 %3, %3, %12;\n\t"
            "addc.cc.u32 %4, %4, %13;\n\t"
            "addc.cc.u32 %5, %5, %14;\n\t"
            "addc.cc.u32 %6, %6, %15;\n\t"
            "addc.cc.u32 %7, %7, %16;\n\t"
            "addc.u32 %8, 0, 0;"
            : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]), "+r"(c[4]), "+r"(c[5]), "+r"(c[6]),
              "+r"(c[7]), "=r"(k0)
            : "r"(g[0]), "r"(g[1]), "r"(g[2]), "r"(g[3]), "r"(g[4]), "r"(g[5]), "r"(g[6]),
              "r"(g[7]));
        asm("add.cc.u32 %0, %0, %9;\n\t"
            "addc.cc.u32 %1, %1, 0;\n\t"
            "addc.cc.u32 %2, %2, 0;\n\t"
            "addc.cc.u32 %3, %3, 0;\n\t"
            "addc.cc.u32 %4, %4, 0;\n\t"
            "addc.cc.u32 %5, %5, 0;\n\t"
            "addc.cc.u32 %6, %6, 0;\n\t"
            "addc.cc.u32 %7, %7, 0;\n\t"
            "addc.u32 %8, %8, 0;"
            : "+r"(c[8]), "+r"(c[9]), "+r"(c[10]), "+r"(c[11]), "+r"(c[12]), "+r"(c[13]),
              "+r"(c[14]), "+r"(c[15]), "+r"(k)
            : "r"(k0));
        summed_reduce(r, c, k);
    }
};

// form 0: the P-256 prime on CiosOp; 1: SolinasSummedOnce (its pair form
// differs from the shipped kernel's; its plain form is the same)
extern "C" int probe_field_mul_form(int form, long long N, long long K,
                                    const void* a, long long as0, long long as1,
                                    const void* b, long long bs0, long long bs1,
                                    const void* d, long long ds0, long long ds1,
                                    const void* e, long long es0, long long es1,
                                    void* out, int threads, void* stream) {
    const Operand A{(const uint32_t*)a, as0, as1}, B{(const uint32_t*)b, bs0, bs1};
    const Operand D{(const uint32_t*)d, ds0, ds1}, E{(const uint32_t*)e, es0, es1};
    cudaStream_t st = (cudaStream_t)stream;
    if (form == 0) {
        launch_mul<CiosOp<ZK_P256_P>>(N, K, A, B, D, E, (uint32_t*)out, threads, st);
    } else {
        launch_mul<SolinasSummedOnce>(N, K, A, B, D, E, (uint32_t*)out, threads, st);
    }
    return (int)cudaGetLastError();
}

// the chain form on CiosOp<ZK_P256_P>: two Montgomery products a link
extern "C" int probe_field_chain_cios(long long R, int n, const void* values, const void* factors,
                                      void* out, int threads, void* stream) {
    field_chain_kernel<CiosOp<ZK_P256_P>><<<(unsigned)((R + threads - 1) / threads), threads, 0,
                                            (cudaStream_t)stream>>>(
        R, n, (const uint32_t*)values, (const uint32_t*)factors, (uint32_t*)out);
    return (int)cudaGetLastError();
}
