// Host C++ core of the port's data layer (ocm_tpu_torch/utils/native.py).
//
// This package's own copy of the JAX package's native/ccl.cpp, kept
// function for function so that both packages segment and quantize
// identically.  It segments hyperspectral cubes on the host (the
// reference's scipy.ndimage.label over a mean-intensity background mask,
// nut_data.py:65-71) and prepares int8 serving chunks:
//
//   ocm_mean_image   — wavelength-mean reduction, threaded over rows
//                      (one streaming pass over the cube)
//   ocm_label        — 8-connected two-pass union-find labeling of the
//                      foreground mask, labels 1..n (0 = background),
//                      relabeled to scipy.ndimage.label's row-major
//                      first-appearance order so outputs are
//                      interchangeable
//   ocm_object_sizes — per-label pixel counts
//   ocm_gather_object— gather one object's spectra into a dense
//                      (n_pixels, L) block, threaded over pixels
//   ocm_quantize_rows_int8 — fused center + per-row int8 quantization +
//                      exact row norms, SIMCAScorer's int8 chunk prep
//   ocm_threads_for  — the thread count the threaded passes pick for a
//                      given amount of work (reported beside timings)
//
// Exposed through a C ABI for ctypes.  Built with
// g++ -O3 -std=c++17 -fPIC -shared -pthread at first use; there is no
// fallback: a failed build raises with the compiler's output.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int n_threads_for(int64_t work) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  int64_t per = 1 << 16;  // don't spawn threads for tiny images
  int64_t want = work / per + 1;
  return static_cast<int>(want < hw ? want : hw);
}

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;
  }
};

}  // namespace

extern "C" {

// the number of threads the passes below use for `work` elements
int32_t ocm_threads_for(int64_t work) { return n_threads_for(work); }

// mean over the wavelength axis of a (h, w, l) float32 cube -> (h, w)
void ocm_mean_image(const float* cube, int64_t h, int64_t w, int64_t l,
                    float* out) {
  const int64_t n_px = h * w;
  int nt = n_threads_for(n_px * l);
  std::vector<std::thread> threads;
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t p = begin; p < end; ++p) {
      const float* row = cube + p * l;
      double acc = 0.0;
      for (int64_t i = 0; i < l; ++i) acc += row[i];
      out[p] = static_cast<float>(acc / static_cast<double>(l));
    }
  };
  int64_t chunk = (n_px + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min(n_px, b + chunk);
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
}

// 8-connected labeling of mask (h, w) uint8; labels_out (h, w) int32 with
// 0 = background and components numbered 1..return_value in scipy's
// row-major first-appearance order.
int32_t ocm_label(const uint8_t* mask, int64_t h, int64_t w,
                  int32_t* labels_out) {
  const int64_t n = h * w;
  // first pass: provisional labels + equivalences
  std::vector<int32_t> prov(n, 0);
  UnionFind uf(1);
  uf.parent.reserve(1024);
  int32_t next = 1;
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      const int64_t i = y * w + x;
      if (!mask[i]) continue;
      // neighbors already visited in raster order: W, NW, N, NE
      int32_t neigh[4];
      int nn = 0;
      if (x > 0 && prov[i - 1]) neigh[nn++] = prov[i - 1];
      if (y > 0) {
        const int64_t up = i - w;
        if (x > 0 && prov[up - 1]) neigh[nn++] = prov[up - 1];
        if (prov[up]) neigh[nn++] = prov[up];
        if (x + 1 < w && prov[up + 1]) neigh[nn++] = prov[up + 1];
      }
      if (nn == 0) {
        prov[i] = next++;
        uf.parent.push_back(prov[i]);
      } else {
        int32_t m = neigh[0];
        for (int k = 1; k < nn; ++k) m = std::min(m, neigh[k]);
        prov[i] = m;
        for (int k = 0; k < nn; ++k) uf.unite(m, neigh[k]);
      }
    }
  }
  // second pass: resolve roots, relabel in first-appearance order
  std::vector<int32_t> remap(static_cast<size_t>(next), 0);
  int32_t n_objects = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!prov[i]) {
      labels_out[i] = 0;
      continue;
    }
    int32_t root = uf.find(prov[i]);
    if (!remap[root]) remap[root] = ++n_objects;
    labels_out[i] = remap[root];
  }
  return n_objects;
}

// per-label pixel counts; sizes_out has n_labels entries (label k -> k-1)
void ocm_object_sizes(const int32_t* labels, int64_t n, int32_t n_labels,
                      int32_t* sizes_out) {
  std::memset(sizes_out, 0, sizeof(int32_t) * n_labels);
  for (int64_t i = 0; i < n; ++i) {
    if (labels[i] > 0) sizes_out[labels[i] - 1] += 1;
  }
}

// gather the spectra of one object into out (n_pixels, l), row-major over
// the cube scan order; coords_out (n_pixels, 2) receives (y, x) pairs.
void ocm_gather_object(const float* cube, const int32_t* labels,
                       int64_t h, int64_t w, int64_t l, int32_t label,
                       float* out, int32_t* coords_out) {
  // index pass (cheap), then threaded copy (bandwidth-bound)
  std::vector<int64_t> idx;
  for (int64_t p = 0; p < h * w; ++p) {
    if (labels[p] == label) idx.push_back(p);
  }
  const int64_t m = static_cast<int64_t>(idx.size());
  int nt = n_threads_for(m * l);
  std::vector<std::thread> threads;
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t r = begin; r < end; ++r) {
      const int64_t p = idx[r];
      std::memcpy(out + r * l, cube + p * l, sizeof(float) * l);
      coords_out[2 * r] = static_cast<int32_t>(p / w);
      coords_out[2 * r + 1] = static_cast<int32_t>(p % w);
    }
  };
  int64_t chunk = (m + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min(m, b + chunk);
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
}

// Per-row symmetric int8 quantization of an (n, l) f32 matrix, optionally
// centered against a shared (l,) offset first: the serving layer's hot
// host-prep (ops/linalg.py quantize_rows_int8).  Bit-identical to
// the NumPy reference: scale = max(amax/127, 1e-30) in f32, values round
// half-to-even (nearbyintf under the default FE_TONEAREST), sumsq is the
// exact int32 sum of squares cast to f32 then scaled left-associatively.
// Threaded over rows; each row is two streaming passes (amax, then
// quantize+accumulate) instead of NumPy's ~six materializing ones.
void ocm_quantize_rows_int8(const float* x, const float* center,
                            int64_t n, int64_t l, int8_t* q,
                            float* scale, float* sumsq) {
  int nt = n_threads_for(n * l);
  std::vector<std::thread> threads;
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t r = begin; r < end; ++r) {
      const float* row = x + r * l;
      float amax = 0.0f;
      if (center) {
        for (int64_t i = 0; i < l; ++i) {
          float v = std::fabs(row[i] - center[i]);
          if (v > amax) amax = v;
        }
      } else {
        for (int64_t i = 0; i < l; ++i) {
          float v = std::fabs(row[i]);
          if (v > amax) amax = v;
        }
      }
      float s = amax / 127.0f;
      if (s < 1e-30f) s = 1e-30f;
      scale[r] = s;
      int8_t* qrow = q + r * l;
      int64_t isum = 0;
      for (int64_t i = 0; i < l; ++i) {
        float v = center ? row[i] - center[i] : row[i];
        float rv = std::nearbyintf(v / s);
        if (rv > 127.0f) rv = 127.0f;
        if (rv < -127.0f) rv = -127.0f;
        int32_t qi = static_cast<int32_t>(rv);
        qrow[i] = static_cast<int8_t>(qi);
        isum += static_cast<int64_t>(qi) * qi;
      }
      // NumPy sums in int32 (exact for l*127^2 < 2^31) then casts f32
      sumsq[r] = static_cast<float>(static_cast<int32_t>(isum)) * s * s;
    }
  };
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
