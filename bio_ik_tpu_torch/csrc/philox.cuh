// The in-kernel random stream, shared by csrc/megastep.cu and
// csrc/species.cu: counter-based Philox4x32-10 (Salmon et al., SC'11) under
// key (seed, 0) at counter (lane, step, generation, draw), the salt of the
// lane's scenario XORed into every word, and the maps from words to draws.
//
// The plain torch versions are bio_ik_tpu_torch/kernels/bio2_fullstep.py
// (philox4x32, philox_words, u01_from_bits, packed_fields,
// clt4_from_fields, rates_from_words) and, for how a step's draws map to
// counters, kernels/bio2_megastep.py::philox_draw; both draw the same bits.

#pragma once

#include <stdint.h>

struct U4 { uint32_t x, y, z, w; };

__device__ __forceinline__ U4 philox4x32(uint32_t c0, uint32_t c1,
                                         uint32_t c2, uint32_t c3,
                                         uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
  }
  return U4{c0, c1, c2, c3};
}

__device__ __forceinline__ U4 salted(U4 w, uint32_t salt) {
  return U4{w.x ^ salt, w.y ^ salt, w.z ^ salt, w.w ^ salt};
}

__device__ __forceinline__ float u01(uint32_t bits, float lo) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f) + lo;
}

// Irwin–Hall: four 24-bit fields summed exactly in integers (< 2^26), one
// conversion, one scale: (Σ/2^24 − 2)·√3 (bio2_fullstep.clt4_from_fields).
__device__ __forceinline__ float clt4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return ((float)(a + b + c + d) * (1.0f / 16777216.0f) - 2.0f) * 1.7320508f;
}

// Rate 2^(k−23) of child c from the 4-bit field c of a generation's rate
// call (bio2_fullstep.rate_from_bits on field c).
__device__ __forceinline__ float rate_of_field(U4 w, int c) {
  const uint32_t word = c < 8 ? w.x : (c < 16 ? w.y : w.z);
  const uint32_t k = (word >> (4 * (c & 7))) & 15u;
  return __int_as_float((int)((k + 104u) << 23));
}

// Philox calls of a child's CLT4 Gaussians: its V Gaussians take 4V
// 24-bit fields, packed four to three words (bio2_fullstep.packed_fields).
template <int V>
__host__ __device__ constexpr int clt4_calls() { return (3 * V + 3) / 4; }

// 24-bit field f of a word sequence read as one little-endian bit string.
template <int NW>
__device__ __forceinline__ uint32_t field24(const uint32_t (&w)[NW], int f) {
  const int i = (24 * f) >> 5, o = (24 * f) & 31;
  return (o <= 8 ? w[i] >> o : __funnelshift_r(w[i], w[i + 1], o)) & 0xFFFFFFu;
}

// field24 of the salted words (each word XORed with `salt`) from the
// unsalted ones: the XOR commutes with the shifts, so the field is the
// unsalted field XOR the salt rotated by the field's bit offset —
// srot[i] = rotr(salt, 8·i) & 0xFFFFFF for offsets 0, 8, 16, 24.
template <int NW>
__device__ __forceinline__ uint32_t field24_salted(const uint32_t (&w)[NW], int f,
                                                   const uint32_t (&srot)[4]) {
  const int i = (24 * f) >> 5, o = (24 * f) & 31;
  const uint32_t x = o <= 8 ? w[i] >> o : __funnelshift_r(w[i], w[i + 1], o);
  return (x ^ srot[o >> 3]) & 0xFFFFFFu;
}
