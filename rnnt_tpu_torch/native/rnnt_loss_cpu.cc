// RNN-T loss, CPU reference — native component of rnnt_tpu_torch (a copy of
// rnnt_tpu/native/rnnt_loss_cpu.cc).
//
// Role parity: warp-transducer's OpenMP CPU build (the reference's
// cmake/warp-rnnt-cmakelist.txt:119 `rnnt_entrypoint.cpp` path).  Used as an
// independent oracle for the JAX/Pallas kernels (tests) and for CPU-only
// inference scoring.  Same convention as rnnt_tpu_torch.ops.rnnt_loss: raw logits
// in, log-softmax owned here, per-example NLL (and optional gradient) out.
//
// Layout: logits [B, T, U1, V] row-major, labels [B, U1-1], blank id = 0.
// Parallelism: one OpenMP task per batch element.
//
// Build: g++ -O3 -fopenmp -shared -fPIC rnnt_loss_cpu.cc -o ... (build.py)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline float LogAddExp(float a, float b) {
  if (a == -INFINITY) return b;
  if (b == -INFINITY) return a;
  const float m = a > b ? a : b;
  return m + std::log1p(std::exp(-std::fabs(a - b)));
}

}  // namespace

extern "C" {

// Returns 0 on success. grad may be null (loss only).
int rnnt_loss_cpu(const float* logits, const int32_t* labels,
                  const int32_t* f_lens, const int32_t* y_lens, int B, int T,
                  int U1, int V, float* loss, float* grad) {
  if (!logits || !labels || !f_lens || !y_lens || !loss) return 1;
  const int64_t strideT = static_cast<int64_t>(U1) * V;
  const int64_t strideB = static_cast<int64_t>(T) * strideT;
  int err = 0;

#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < B; ++b) {
    const int Tb = f_lens[b];
    const int Ub = y_lens[b];
    if (Tb < 1 || Tb > T || Ub < 0 || Ub >= U1) {
#pragma omp critical
      err = 2;
      continue;
    }
    const float* lg = logits + b * strideB;
    const int32_t* lab = labels + b * (U1 - 1);

    // log-softmax denominators, then blank/emit coefficient planes
    std::vector<float> lb(static_cast<size_t>(Tb) * (Ub + 1));
    std::vector<float> le(static_cast<size_t>(Tb) * (Ub + 1), -INFINITY);
    std::vector<float> lse(static_cast<size_t>(Tb) * (Ub + 1));
    for (int t = 0; t < Tb; ++t) {
      for (int u = 0; u <= Ub; ++u) {
        const float* row = lg + t * strideT + static_cast<int64_t>(u) * V;
        float mx = row[0];
        for (int v = 1; v < V; ++v) mx = row[v] > mx ? row[v] : mx;
        float s = 0.f;
        for (int v = 0; v < V; ++v) s += std::exp(row[v] - mx);
        const float denom = mx + std::log(s);
        lse[t * (Ub + 1) + u] = denom;
        lb[t * (Ub + 1) + u] = row[0] - denom;
        if (u < Ub) le[t * (Ub + 1) + u] = row[lab[u]] - denom;
      }
    }

    auto B_ = [&](int t, int u) -> float { return lb[t * (Ub + 1) + u]; };
    auto E_ = [&](int t, int u) -> float { return le[t * (Ub + 1) + u]; };

    // alpha
    std::vector<float> alpha(static_cast<size_t>(Tb) * (Ub + 1), -INFINITY);
    alpha[0] = 0.f;
    for (int t = 0; t < Tb; ++t) {
      for (int u = 0; u <= Ub; ++u) {
        if (t == 0 && u == 0) continue;
        float acc = -INFINITY;
        if (t > 0) acc = LogAddExp(acc, alpha[(t - 1) * (Ub + 1) + u] + B_(t - 1, u));
        if (u > 0) acc = LogAddExp(acc, alpha[t * (Ub + 1) + u - 1] + E_(t, u - 1));
        alpha[t * (Ub + 1) + u] = acc;
      }
    }
    const float ll = alpha[(Tb - 1) * (Ub + 1) + Ub] + B_(Tb - 1, Ub);
    loss[b] = -ll;

    if (!grad) continue;

    // beta
    std::vector<float> beta(static_cast<size_t>(Tb) * (Ub + 1), -INFINITY);
    beta[(Tb - 1) * (Ub + 1) + Ub] = B_(Tb - 1, Ub);
    for (int t = Tb - 1; t >= 0; --t) {
      for (int u = Ub; u >= 0; --u) {
        if (t == Tb - 1 && u == Ub) continue;
        float acc = -INFINITY;
        if (t + 1 < Tb) acc = LogAddExp(acc, B_(t, u) + beta[(t + 1) * (Ub + 1) + u]);
        if (u + 1 <= Ub) acc = LogAddExp(acc, E_(t, u) + beta[t * (Ub + 1) + u + 1]);
        beta[t * (Ub + 1) + u] = acc;
      }
    }

    // gradient: softmax * occ - transition occupancies
    float* gb = grad + b * strideB;
    std::memset(gb, 0, sizeof(float) * strideB);
    for (int t = 0; t < Tb; ++t) {
      for (int u = 0; u <= Ub; ++u) {
        const float* row = lg + t * strideT + static_cast<int64_t>(u) * V;
        float* grow = gb + t * strideT + static_cast<int64_t>(u) * V;
        const float a = alpha[t * (Ub + 1) + u];
        const float occ = std::exp(a + beta[t * (Ub + 1) + u] - ll);
        const float denom = lse[t * (Ub + 1) + u];
        for (int v = 0; v < V; ++v)
          grow[v] = std::exp(row[v] - denom) * occ;
        // blank transition
        float beta_dn;
        if (t == Tb - 1)
          beta_dn = (u == Ub) ? 0.f : -INFINITY;
        else
          beta_dn = beta[(t + 1) * (Ub + 1) + u];
        grow[0] -= std::exp(a + B_(t, u) + beta_dn - ll);
        // emit transition
        if (u < Ub)
          grow[lab[u]] -= std::exp(a + E_(t, u) + beta[t * (Ub + 1) + u + 1] - ll);
      }
    }
  }
  return err;
}

}  // extern "C"
