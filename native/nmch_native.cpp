// nmch_native: C++ runtime components of NMCH.
//
// The CUDA reference is native end-to-end; the GPU compute path lives in
// JAX/Pallas, and this library provides the native host-side pieces:
//
//  * a semi-analytic Heston call oracle (characteristic function +
//    Gauss-Legendre quadrature) — an implementation fully independent of
//    the Python/numpy oracle in nmch/oracle/heston.py, used to
//    cross-validate it;
//  * the reference's Abramowitz-Stegun normal CDF and Black-Scholes
//    "true price" (parity with src/NMCH/utils/utils.cu:5-25 and
//    NMCH_FE.cu:336-338);
//  * the reference's 95%-CI error formula (NMCH_FE.hpp:50-55);
//  * an independent CPU Monte Carlo FE pricer (xoshiro128++ RNG,
//    one-thread-per-path loop like the reference's playbooks) used as a
//    statistical cross-check of the JAX engines.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Build: make -C native  (g++ -O3 -shared -fPIC)

#include <cmath>
#include <complex>
#include <cstdint>
#include <random>
#include <vector>

namespace {

using cplx = std::complex<double>;

// ---------------------------------------------------------------------
// Gauss-Legendre nodes/weights on [-1, 1] via Newton iteration on P_n.
void gauss_legendre(int n, std::vector<double>& x, std::vector<double>& w) {
    x.assign(n, 0.0);
    w.assign(n, 0.0);
    const int m = (n + 1) / 2;
    for (int i = 0; i < m; ++i) {
        // Chebyshev initial guess
        double z = std::cos(M_PI * (i + 0.75) / (n + 0.5));
        double pp = 0.0;
        for (int it = 0; it < 100; ++it) {
            double p0 = 1.0, p1 = 0.0;
            for (int j = 0; j < n; ++j) {
                double p2 = p1;
                p1 = p0;
                p0 = ((2.0 * j + 1.0) * z * p1 - j * p2) / (j + 1.0);
            }
            pp = n * (z * p0 - p1) / (z * z - 1.0);
            double z1 = z;
            z = z1 - p0 / pp;
            if (std::abs(z - z1) < 1e-15) break;
        }
        x[i] = -z;
        x[n - 1 - i] = z;
        w[i] = 2.0 / ((1.0 - z * z) * pp * pp);
        w[n - 1 - i] = w[i];
    }
}

// Heston characteristic function E[exp(iu ln S_T)], "little trap" branch.
cplx heston_phi(cplx u, double T, double S0, double r, double k, double rho,
                double theta, double sigma, double v0) {
    const cplx iu = cplx(0.0, 1.0) * u;
    const cplx a = k - rho * sigma * iu;
    const cplx d = std::sqrt(a * a + sigma * sigma * (iu + u * u));
    const cplx g = (a - d) / (a + d);
    const cplx e_dt = std::exp(-d * T);
    const cplx C = (k * theta / (sigma * sigma)) *
                   ((a - d) * T - 2.0 * std::log((1.0 - g * e_dt) / (1.0 - g)));
    const cplx D = ((a - d) / (sigma * sigma)) * (1.0 - e_dt) / (1.0 - g * e_dt);
    return std::exp(C + D * v0 + iu * (std::log(S0) + r * T));
}

// xoshiro128++ (Blackman & Vigna) — deliberately a different generator
// family from the framework's Philox so the CPU validator is an
// independent draw source.

// splitmix64 finalizer: hashes a per-path seed so consecutive path
// indices map to well-separated generator states (single-word MT
// seeding of affine-sequential integers gives weak stream separation).
static inline uint64_t splitmix64_mix(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

struct Xoshiro128pp {
    uint32_t s[4];
    explicit Xoshiro128pp(uint64_t seed) {
        // splitmix64 expansion
        uint64_t x = seed;
        for (int i = 0; i < 4; ++i) {
            x += 0x9E3779B97f4A7C15ULL;
            uint64_t z = x;
            z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
            z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
            s[i] = static_cast<uint32_t>((z ^ (z >> 31)) & 0xFFFFFFFFULL);
        }
    }
    static uint32_t rotl(uint32_t v, int k) {
        return (v << k) | (v >> (32 - k));
    }
    uint32_t next() {
        const uint32_t result = rotl(s[0] + s[3], 7) + s[0];
        const uint32_t t = s[1] << 9;
        s[2] ^= s[0];
        s[3] ^= s[1];
        s[1] ^= s[2];
        s[0] ^= s[3];
        s[2] ^= t;
        s[3] = rotl(s[3], 11);
        return result;
    }
    double uniform() {  // (0, 1]
        return (static_cast<double>(next()) + 1.0) * (1.0 / 4294967296.0);
    }
    // Box-Muller pair
    void normal2(double& g1, double& g2) {
        double u1 = uniform(), u2 = uniform();
        double rr = std::sqrt(-2.0 * std::log(u1));
        g1 = rr * std::cos(2.0 * M_PI * u2);
        g2 = rr * std::sin(2.0 * M_PI * u2);
    }
};

}  // namespace

extern "C" {

// Semi-analytic Heston European call via the P1/P2 decomposition.
double nmch_heston_call(double T, double S0, double v0, double r, double k,
                        double rho, double theta, double sigma, double K,
                        double u_max, int n_nodes) {
    std::vector<double> x, w;
    gauss_legendre(n_nodes, x, w);
    const double lnK = std::log(K);
    const cplx phi_mi =
        heston_phi(cplx(0.0, -1.0), T, S0, r, k, rho, theta, sigma, v0);
    double P1 = 0.5, P2 = 0.5;
    for (int i = 0; i < n_nodes; ++i) {
        const double u = 0.5 * u_max * (x[i] + 1.0);
        const double wu = 0.5 * u_max * w[i];
        const cplx eiu = std::exp(cplx(0.0, -u * lnK));
        const cplx pu = heston_phi(cplx(u, 0.0), T, S0, r, k, rho, theta,
                                   sigma, v0);
        const cplx pumi = heston_phi(cplx(u, -1.0), T, S0, r, k, rho, theta,
                                     sigma, v0);
        const cplx iu = cplx(0.0, u);
        P2 += wu * std::real(eiu * pu / iu) / M_PI;
        P1 += wu * std::real(eiu * pumi / (iu * phi_mi)) / M_PI;
    }
    return S0 * P1 - K * std::exp(-r * T) * P2;
}

// Abramowitz-Stegun polynomial normal CDF — bit-parity with the
// reference's nmch::utils::NP (utils.cu:5-25).
double nmch_norm_cdf_as(double x) {
    const double p = 0.2316419;
    const double b1 = 0.319381530, b2 = -0.356563782, b3 = 1.781477937,
                 b4 = -1.821255978, b5 = 1.330274429;
    const double ax = std::fabs(x);
    double nd = 1.0;
    if (ax <= 10.0) {
        const double t = 1.0 / (1.0 + p * ax);
        const double phi = std::exp(-ax * ax / 2.0) / std::sqrt(2.0 * M_PI);
        nd = 1.0 - phi * (t * (b1 + t * (b2 + t * (b3 + t * (b4 + t * b5)))));
    }
    return x >= 0.0 ? nd : 1.0 - nd;
}

// The reference's printed "true price": BS with vol = sigma, T = 1 baked
// in (NMCH_FE.cu:336-338).
double nmch_reference_true_price(double S0, double K, double r,
                                 double sigma) {
    const double d1 = (r + 0.5 * sigma * sigma) / sigma;
    const double d2 = (r - 0.5 * sigma * sigma) / sigma;
    return S0 * nmch_norm_cdf_as(d1) - K * std::exp(-r) * nmch_norm_cdf_as(d2);
}

// Reference 95%-CI half width (NMCH_FE.hpp:50-55), verbatim.
double nmch_reference_err(double mean, double mean_sq, long long n) {
    if (n <= 1) return NAN;
    const double v = (1.0 / (n - 1)) * (static_cast<double>(n) * mean_sq -
                                        mean * mean);
    if (v < 0.0) return NAN;
    return 1.96 * std::sqrt(v) / std::sqrt(static_cast<double>(n));
}

// Independent CPU Forward-Euler Monte Carlo: fills out[0] = E[X],
// out[1] = E[X^2] with X = (S_T - K)^+.  Same discretization as
// ops/fe.py (reflected variance), different RNG family on purpose.
void nmch_cpu_fe_moments(double T, double S0, double v0, double r, double k,
                         double rho, double theta, double sigma, double K,
                         int N, long long n_paths, uint64_t seed,
                         double* out) {
    const double dt = T / N;
    const double sqdt = std::sqrt(dt);
    const double q = std::sqrt(1.0 - rho * rho);
    double sum = 0.0, sumsq = 0.0;
    for (long long p = 0; p < n_paths; ++p) {
        Xoshiro128pp rng(seed * 0x9E3779B97f4A7C15ULL + p + 1);
        double S = S0, v = v0;
        for (int i = 0; i < N; ++i) {
            double g1, g2;
            rng.normal2(g1, g2);
            const double sq = std::sqrt(v);
            S += r * S * dt + sq * S * sqdt * (rho * g1 + q * g2);
            v = std::fabs(v + k * (theta - v) * dt + sigma * sq * sqdt * g1);
        }
        const double pay = S > K ? S - K : 0.0;
        sum += pay;
        sumsq += pay * pay;
    }
    out[0] = sum / n_paths;
    out[1] = sumsq / n_paths;
}

// Independent CPU Broadie-Kaya "Exact Method" Monte Carlo: fills
// out[0] = E[X], out[1] = E[X^2].  Same variance-transition law and
// terminal conditional formula as ops/em.py (reference
// NMCH_EM.cu:96-124, generalized over T/S0/r), but sampled with the
// C++ standard library's OWN poisson/gamma/normal distributions and
// mt19937_64 — a fully independent implementation used to
// statistically cross-validate the JAX EM engines (which rebuild the
// samplers from scratch as masked rejection rounds).
// conditional != 0: X = E[(S_T-K)^+ | variance path] in closed form
// (Phi via erfc — not the A-S approximation, for independence).
void nmch_cpu_em_moments(double T, double S0, double v0, double r, double k,
                         double rho, double theta, double sigma, double K,
                         int N, long long n_paths, uint64_t seed,
                         int conditional, double* out) {
    const double dt = T / N;
    const double ekdt = std::exp(-k * dt);
    const double sig2 = sigma * sigma;
    const double d = 2.0 * k * theta / sig2;
    const double lam_const = 2.0 * k * ekdt / (sig2 * (1.0 - ekdt));
    const double vfac = sig2 * (1.0 - ekdt) / (2.0 * k);
    const double rho_c2 = 1.0 - rho * rho;
    auto Phi = [](double x) { return 0.5 * std::erfc(-x / M_SQRT2); };
    double sum = 0.0, sumsq = 0.0;
    std::normal_distribution<double> nd(0.0, 1.0);
    for (long long p = 0; p < n_paths; ++p) {
        std::mt19937_64 gen(splitmix64_mix(
            seed * 0x9E3779B97F4A7C15ULL + static_cast<uint64_t>(p) + 1));
        double v = v0, vI = 0.0;
        for (int i = 0; i < N; ++i) {
            const double lam = lam_const * v;
            std::poisson_distribution<long long> pois(lam);
            const long long Np = pois(gen);
            std::gamma_distribution<double> gam(d + Np, 1.0);
            const double v_next = vfac * gam(gen);
            vI += v + v_next;              // dt/2 applied after the loop
            v = v_next;
        }
        vI *= dt * 0.5;
        const double m = std::log(S0) + r * T - 0.5 * vI +
                         (rho / sigma) * (v - v0 - k * theta * T + k * vI);
        const double s = std::sqrt(rho_c2 * vI);
        double pay;
        if (conditional) {
            const double dd = (std::log(K) - m) / (s > 1e-300 ? s : 1e-300);
            pay = std::exp(m + 0.5 * s * s) * Phi(s - dd) - K * Phi(-dd);
        } else {
            const double ST = std::exp(m + s * nd(gen));
            pay = ST > K ? ST - K : 0.0;
        }
        sum += pay;
        sumsq += pay * pay;
    }
    out[0] = sum / n_paths;
    out[1] = sumsq / n_paths;
}

}  // extern "C"
