// Host-side scene fill of nbodyax_torch: the reference's random scene drawn
// by its combined generator (64-bit LCG u, 64-bit xorshift v, 32-bit
// multiply-with-carry w; the published Numerical Recipes constants), bit
// for bit the stream of nbodyax_torch/rng.py's RefRandgen. The recurrence
// is sequential, so a 1M-body scene is 4M dependent draws: a few ms here,
// seconds in pure Python. Host code, not a kernel: built with g++ and
// loaded with ctypes by nbodyax_torch/native.py.

#include <cstdint>

namespace {

struct Randgen {
    uint64_t u, v, w;

    explicit Randgen(uint64_t s) { seed(s); }

    void seed(uint64_t s) {
        v = 4101842887655102017ULL;
        w = 1;
        u = s ^ v;
        ival64();
        v = u;
        ival64();
        w = v;
        ival64();
    }

    inline void advance() {
        u = u * 2862933555777941757ULL + 7046029254386353087ULL;
        v ^= v >> 17;
        v ^= v << 31;
        v ^= v >> 8;
        w = 4294957665ULL * (w & 0xffffffffULL) + (w >> 32);
    }

    inline uint64_t ival64() {
        advance();
        uint64_t x = u ^ (u << 21);
        x ^= x >> 35;
        x ^= x << 4;
        return (x + v) ^ w;
    }

    inline double fval() { return 5.42101086242752217E-20 * ival64(); }

    inline double fval(double a, double b) { return fval() * (b - a) + a; }
};

}  // namespace

extern "C" {

// The raw uint64 stream of ``seed``.
void nbx_ival64_sequence(uint64_t seed, int64_t n, uint64_t* out) {
    Randgen g(seed);
    for (int64_t i = 0; i < n; ++i) out[i] = g.ival64();
}

// The reference scene: per body x, y, mass, radius, each computed in double
// and narrowed to float on store, the mass and radius bounds narrowed to
// float before the draw. Velocities start at zero.
void nbx_scene_fill(uint64_t seed, int64_t n,
                    int64_t field_width, int64_t field_height,
                    float min_mass, float max_mass,
                    float min_radius, float max_radius,
                    float* pos /* [n][2] */, float* vel /* [n][2] */,
                    float* mass /* [n] */, float* radius /* [n] */) {
    Randgen g(seed);
    const double dw = 2.0 * static_cast<double>(field_width);
    const double dh = 2.0 * static_cast<double>(field_height);
    for (int64_t i = 0; i < n; ++i) {
        pos[2 * i + 0] = static_cast<float>(
            g.fval(0.0, dw) - static_cast<double>(field_width));
        pos[2 * i + 1] = static_cast<float>(
            g.fval(0.0, dh) - static_cast<double>(field_height));
        mass[i] = static_cast<float>(g.fval(min_mass, max_mass));
        radius[i] = static_cast<float>(g.fval(min_radius, max_radius));
        vel[2 * i + 0] = 0.0f;
        vel[2 * i + 1] = 0.0f;
    }
}

int32_t nbx_abi_version(void) { return 1; }

}  // extern "C"
