// Native capture-file decoder: packed-sample unpacking + probe statistics.
//
// The IO layer feeds multi-GB int8/packed IF captures into device memory;
// the bit-unpacking inner loops are branch-heavy byte work that NumPy does
// with several temporary-array passes.  These C implementations run one
// streaming pass (table-driven, 8 samples per output step) and are exposed
// through ctypes (softgnss_tpu_torch.native), as in the JAX package's own
// copy (softgnss_tpu/native/unpack.cpp).  Formats match softgnss_tpu_torch.io:
//
//   int4: two samples/byte, low nibble first, two's complement
//   int2: four samples/byte, LSB-first pairs, {00,01,10,11}->{+1,+3,-1,-3}
//   int1: eight samples/byte, LSB first, {0,1}->{+1,-1}
//
// Built at first use by softgnss_tpu_torch.native:
//   g++ -O3 -shared -fPIC -o libsgunpack.so unpack.cpp

#include <cstdint>
#include <cstddef>

// Lookup tables as function-local statics of constructor-initialized
// structs ("magic statics"): C++11 guarantees the one-time init is
// thread-safe, unlike an if(!init) flag — ctypes releases the GIL during
// foreign calls, so two Python threads may enter concurrently.
namespace {

struct Lut4 {
    int8_t v[256][2];
    Lut4() {
        for (int b = 0; b < 256; ++b) {
            int lo = b & 0x0F, hi = b >> 4;
            v[b][0] = (int8_t)(lo >= 8 ? lo - 16 : lo);
            v[b][1] = (int8_t)(hi >= 8 ? hi - 16 : hi);
        }
    }
};

struct Lut2 {
    int8_t v[256][4];
    Lut2() {
        static const int8_t map2[4] = {1, 3, -1, -3};
        for (int b = 0; b < 256; ++b)
            for (int s = 0; s < 4; ++s)
                v[b][s] = map2[(b >> (2 * s)) & 0x3];
    }
};

struct Lut1 {
    int8_t v[256][8];
    Lut1() {
        for (int b = 0; b < 256; ++b)
            for (int s = 0; s < 8; ++s)
                v[b][s] = ((b >> s) & 1) ? -1 : 1;
    }
};

}  // namespace

extern "C" {

// int4: two samples per byte, low nibble first, two's complement
void unpack_int4(const uint8_t* in, int8_t* out, size_t n_bytes) {
    static const Lut4 lut;
    for (size_t i = 0; i < n_bytes; ++i) {
        out[2 * i] = lut.v[in[i]][0];
        out[2 * i + 1] = lut.v[in[i]][1];
    }
}

// int2: four samples per byte, LSB-first pairs, sign-magnitude {+1,+3,-1,-3}
void unpack_int2(const uint8_t* in, int8_t* out, size_t n_bytes) {
    static const Lut2 lut;
    for (size_t i = 0; i < n_bytes; ++i) {
        const int8_t* v = lut.v[in[i]];
        out[4 * i] = v[0];
        out[4 * i + 1] = v[1];
        out[4 * i + 2] = v[2];
        out[4 * i + 3] = v[3];
    }
}

// int1: eight samples per byte, LSB first, {0,1} -> {+1,-1}
void unpack_int1(const uint8_t* in, int8_t* out, size_t n_bytes) {
    static const Lut1 lut;
    for (size_t i = 0; i < n_bytes; ++i) {
        const int8_t* v = lut.v[in[i]];
        for (int s = 0; s < 8; ++s) out[8 * i + s] = v[s];
    }
}

// int16 little-endian -> int8 (arithmetic >> 8), one pass
void narrow_int16(const int16_t* in, int8_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) out[i] = (int8_t)(in[i] >> 8);
}

// uint8 offset-binary -> int8
void unbias_uint8(const uint8_t* in, int8_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) out[i] = (int8_t)((int)in[i] - 128);
}

// single-pass probe statistics over int8 samples:
// hist: 256 bins (value + 128); returns sum and sum of squares via pointers
void probe_stats(const int8_t* in, size_t n, int64_t* hist,
                 double* sum, double* sumsq) {
    double s = 0.0, s2 = 0.0;
    for (size_t i = 0; i < n; ++i) {
        int v = in[i];
        hist[v + 128] += 1;
        s += v;
        s2 += (double)v * v;
    }
    *sum = s;
    *sumsq = s2;
}

}  // extern "C"
