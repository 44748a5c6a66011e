// SLIC superpixel segmentation — native C++ tier.
//
// TPU-native rebuild of the reference's CPU SLIC path
// (source/reconstructionGPU2/runSLIC_2D.c:340-483 and
// runStackSLIC.cpp segmentSLIC): the reference runs SLIC on the host in
// C before patch extraction; here the same capability is a small C++
// library loaded via ctypes (fetalreconstruction_tpu/native/__init__.py)
// with the NumPy implementation (patches/slic.py) as the oracle/fallback.
//
// Algorithm (identical to patches/slic.py — the two are cross-checked in
// tests/test_native.py):
//   * gray -> CIELAB L lift via the gray->RGB->XYZ->LAB chain,
//   * seeds on a regular grid of step sqrt(h*w/num_superpixels),
//   * k-means iterations restricted to 2S x 2S windows in (L, x, y) with
//     compactness weighting,
//   * connectivity enforcement: 4-connected components >= (step^2)/4 are
//     kept (relabelled sequentially in seed/scan order), orphan pixels are
//     assigned the label of the nearest kept pixel (exact Euclidean
//     distance transform with index tracking, Felzenszwalb/Huttenlocher).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

inline double inv_gamma(double c) {
  c /= 255.0;
  return c <= 0.04045 ? c / 12.92 : std::pow((c + 0.055) / 1.055, 2.4);
}

// CIELAB L of gray (matches patches/slic.py:gray_to_lab_l).
inline double gray_to_lab_l(double g) {
  const double rr = inv_gamma(0.2989 * g);
  const double gg = inv_gamma(0.5870 * g);
  const double bb = inv_gamma(0.1140 * g);
  const double y = 0.212671 * rr + 0.715160 * gg + 0.072169 * bb;
  const double fy =
      y > 0.008856 ? std::cbrt(y) : 7.787 * y + 16.0 / 116.0;
  return 116.0 * fy - 16.0;
}

// 1D squared-distance transform with argmin tracking (lower envelope of
// parabolas). f: input costs, d: output costs, arg: index of the source
// achieving the minimum (propagated through via src).
void edt_1d(const double* f, const int32_t* src, int n, double* d,
            int32_t* arg, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -std::numeric_limits<double>::infinity();
  z[1] = std::numeric_limits<double>::infinity();
  for (int q = 1; q < n; q++) {
    double s;
    while (true) {
      s = ((f[q] + q * (double)q) - (f[v[k]] + v[k] * (double)v[k])) /
          (2.0 * q - 2.0 * v[k]);
      if (s <= z[k]) {
        k--;
      } else {
        break;
      }
    }
    k++;
    v[k] = q;
    z[k] = s;
    z[k + 1] = std::numeric_limits<double>::infinity();
  }
  k = 0;
  for (int q = 0; q < n; q++) {
    while (z[k + 1] < q) k++;
    const double dq = q - (double)v[k];
    d[q] = dq * dq + f[v[k]];
    arg[q] = src[v[k]];
  }
}

}  // namespace

extern "C" {

// Segment one h x w float image. out_labels: int32[h*w]. Returns the
// number of labels (>=1) or -1 on error.
int fr_slic_segment(const float* img, int h, int w, int num_superpixels,
                    double compactness, int iterations,
                    int32_t* out_labels) {
  if (h <= 0 || w <= 0) return -1;
  const int64_t sz = (int64_t)h * w;
  if (num_superpixels < 1) num_superpixels = 1;

  std::vector<double> lvec(sz);
  for (int64_t i = 0; i < sz; i++) lvec[i] = gray_to_lab_l(img[i]);

  int step =
      (int)(std::sqrt((double)sz / (double)num_superpixels) + 0.5);
  if (step < 2) step = 2;

  std::vector<double> sy, sx, sl;
  for (int yy = step / 2; yy < h; yy += step)
    for (int xx = step / 2; xx < w; xx += step) {
      sy.push_back(yy);
      sx.push_back(xx);
      sl.push_back(lvec[(int64_t)yy * w + xx]);
    }
  const int k = (int)sy.size();
  if (k == 0) {
    std::memset(out_labels, 0, sz * sizeof(int32_t));
    return 1;
  }

  std::vector<int32_t> labels(sz, -1);
  std::vector<double> dists(sz);
  const double invwt =
      (compactness / step) * (compactness / step);

  std::vector<double> accy(k), accx(k), accl(k);
  std::vector<int64_t> cnt(k);
  for (int it = 0; it < iterations; it++) {
    std::fill(labels.begin(), labels.end(), -1);
    std::fill(dists.begin(), dists.end(),
              std::numeric_limits<double>::infinity());
    for (int i = 0; i < k; i++) {
      const int y0 = std::max((int)sy[i] - step, 0);
      const int y1 = std::min((int)sy[i] + step, h);
      const int x0 = std::max((int)sx[i] - step, 0);
      const int x1 = std::min((int)sx[i] + step, w);
      for (int yy = y0; yy < y1; yy++) {
        const int64_t row = (int64_t)yy * w;
        const double dy = yy - sy[i];
        for (int xx = x0; xx < x1; xx++) {
          const double dl = lvec[row + xx] - sl[i];
          const double dx = xx - sx[i];
          const double d = dl * dl + (dy * dy + dx * dx) * invwt;
          if (d < dists[row + xx]) {
            dists[row + xx] = d;
            labels[row + xx] = i;
          }
        }
      }
    }
    std::fill(accy.begin(), accy.end(), 0.0);
    std::fill(accx.begin(), accx.end(), 0.0);
    std::fill(accl.begin(), accl.end(), 0.0);
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int yy = 0; yy < h; yy++)
      for (int xx = 0; xx < w; xx++) {
        const int32_t lab = labels[(int64_t)yy * w + xx];
        if (lab >= 0) {
          accy[lab] += yy;
          accx[lab] += xx;
          accl[lab] += lvec[(int64_t)yy * w + xx];
          cnt[lab]++;
        }
      }
    for (int i = 0; i < k; i++)
      if (cnt[i] > 0) {
        sy[i] = accy[i] / cnt[i];
        sx[i] = accx[i] / cnt[i];
        sl[i] = accl[i] / cnt[i];
      }
  }
  for (int64_t i = 0; i < sz; i++)
    if (labels[i] < 0) labels[i] = 0;

  // Connectivity: keep 4-connected components >= min_size, relabel in
  // seed-then-scan order (matches ndimage.label + the python loop).
  const int64_t min_size = ((int64_t)step * step) / 4;
  std::vector<int32_t> out(sz, -1);
  std::vector<int64_t> queue(sz);
  std::vector<uint8_t> seen(sz, 0);
  int32_t next_label = 0;
  for (int i = 0; i < k; i++) {
    for (int64_t start = 0; start < sz; start++) {
      if (labels[start] != i || seen[start]) continue;
      // BFS one component
      int64_t qh = 0, qt = 0;
      queue[qt++] = start;
      seen[start] = 1;
      while (qh < qt) {
        const int64_t p = queue[qh++];
        const int yy = (int)(p / w), xx = (int)(p % w);
        const int64_t nb[4] = {p - w, p + w, p - 1, p + 1};
        const bool ok[4] = {yy > 0, yy < h - 1, xx > 0, xx < w - 1};
        for (int t = 0; t < 4; t++)
          if (ok[t] && !seen[nb[t]] && labels[nb[t]] == i) {
            seen[nb[t]] = 1;
            queue[qt++] = nb[t];
          }
      }
      if (qt >= min_size) {
        for (int64_t t = 0; t < qt; t++) out[queue[t]] = next_label;
        next_label++;
      }
    }
  }
  if (next_label == 0) {
    std::memset(out_labels, 0, sz * sizeof(int32_t));
    return 1;
  }

  // Orphan fill: exact EDT (squared euclidean) with index tracking.
  bool any_orphan = false;
  for (int64_t i = 0; i < sz; i++)
    if (out[i] < 0) {
      any_orphan = true;
      break;
    }
  if (any_orphan) {
    const double INF = 1e18;
    std::vector<double> f((int64_t)h * w), dcol(h), drow(w);
    std::vector<int32_t> srcidx((int64_t)h * w), argcol(h), argrow(w);
    std::vector<int> v(std::max(h, w) + 1);
    std::vector<double> z(std::max(h, w) + 2);
    std::vector<double> fcol(h);
    std::vector<int32_t> scol(h);
    // pass 1: columns
    for (int xx = 0; xx < w; xx++) {
      for (int yy = 0; yy < h; yy++) {
        const int64_t p = (int64_t)yy * w + xx;
        fcol[yy] = out[p] >= 0 ? 0.0 : INF;
        scol[yy] = (int32_t)p;
      }
      edt_1d(fcol.data(), scol.data(), h, dcol.data(), argcol.data(),
             v.data(), z.data());
      for (int yy = 0; yy < h; yy++) {
        f[(int64_t)yy * w + xx] = dcol[yy];
        srcidx[(int64_t)yy * w + xx] = argcol[yy];
      }
    }
    // pass 2: rows
    for (int yy = 0; yy < h; yy++) {
      edt_1d(&f[(int64_t)yy * w], &srcidx[(int64_t)yy * w], w,
             drow.data(), argrow.data(), v.data(), z.data());
      for (int xx = 0; xx < w; xx++) {
        const int64_t p = (int64_t)yy * w + xx;
        if (out[p] < 0) out_labels[p] = out[argrow[xx]];
        else out_labels[p] = out[p];
      }
    }
  } else {
    std::memcpy(out_labels, out.data(), sz * sizeof(int32_t));
  }
  return next_label;
}

// Batched segmentation of n images (n,h,w) with a thread pool.
// out_labels: int32[n*h*w]; out_counts: int32[n]. Returns 0 on success.
int fr_slic_segment_batch(const float* imgs, int n, int h, int w,
                          int num_superpixels, double compactness,
                          int iterations, int nthreads,
                          int32_t* out_labels, int32_t* out_counts) {
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> pool;
  std::vector<int> next(1, 0);
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += nthreads) {
      out_counts[i] = fr_slic_segment(
          imgs + (int64_t)i * h * w, h, w, num_superpixels, compactness,
          iterations, out_labels + (int64_t)i * h * w);
    }
  };
  for (int t = 0; t < nthreads; t++) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
