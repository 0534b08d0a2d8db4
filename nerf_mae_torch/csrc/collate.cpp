// Host-side batch assembly of the training feed (the port's copy of the JAX
// package's native/collate.cpp, same functions and arithmetic).
//
// The per-scene host work of a batch (pad-to-cube copies, the fused
// pad-to-cube + patchify, axis flips, rot90 and the rotate+scale trilinear
// resample) is memory-bandwidth work that Python does poorly. This library
// does it in C++ and is bound with ctypes (nerf_mae_torch/data/native.py),
// which releases the GIL, so the feed's thread pool runs scenes in parallel.
// It is built with g++ at first use; the CPU tests hold every function
// equal to its numpy version.
//
// Layout contract: all grids are channel-last float32 (W, L, H, C)
// row-major, matching the on-disk npz layout and the batches.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Zero-pad/crop one scene (w,l,h,c) into a (r,r,r,c) slot.
void pad_to_cube(const float* src, int64_t w, int64_t l, int64_t h, int64_t c,
                 float* dst, int64_t r) {
    const int64_t cw = std::min(w, r), cl = std::min(l, r), ch = std::min(h, r);
    std::memset(dst, 0, sizeof(float) * r * r * r * c);
    for (int64_t i = 0; i < cw; ++i) {
        for (int64_t j = 0; j < cl; ++j) {
            const float* s = src + ((i * l + j) * h) * c;
            float* d = dst + ((i * r + j) * r) * c;
            std::memcpy(d, s, sizeof(float) * ch * c);
        }
    }
}

// In-place-style flip along axis 0 or 1 (z-up augmentation axes). src and
// dst must not alias.
void flip_axis(const float* src, int64_t w, int64_t l, int64_t h, int64_t c,
               int axis, float* dst) {
    for (int64_t i = 0; i < w; ++i) {
        const int64_t si = (axis == 0) ? (w - 1 - i) : i;
        for (int64_t j = 0; j < l; ++j) {
            const int64_t sj = (axis == 1) ? (l - 1 - j) : j;
            const float* s = src + ((si * l + sj) * h) * c;
            float* d = dst + ((i * l + j) * h) * c;
            std::memcpy(d, s, sizeof(float) * h * c);
        }
    }
}

// rot90 in the (w, l) plane: out[i, j] = in[j, l-1-i] — the swapaxes(0,1)
// + flip(0) the reference applies (reference: nerf_rpn/datasets.py:198-205).
// Output dims are (l, w, h, c).
void rot90_wl(const float* src, int64_t w, int64_t l, int64_t h, int64_t c,
              float* dst) {
    for (int64_t i = 0; i < l; ++i) {       // new W = l
        for (int64_t j = 0; j < w; ++j) {   // new L = w
            const float* s = src + ((j * l + (l - 1 - i)) * h) * c;
            float* d = dst + ((i * w + j) * h) * c;
            std::memcpy(d, s, sizeof(float) * h * c);
        }
    }
}

// Trilinear rotate(+scale) resample about the volume center, z-rotation,
// zero padding, align-corners voxel-centered coords — same sampling
// semantics as data/datasets.py rotate_and_scale_scene.
void rotate_scale(const float* src, int64_t w, int64_t l, int64_t h, int64_t c,
                  float angle, float scale, float* dst) {
    const float ca = std::cos(angle) * scale, sa = std::sin(angle) * scale;
    const int64_t dims[3] = {w, l, h};
    for (int64_t i = 0; i < w; ++i) {
        const float vx = (2.0f * i / std::max<int64_t>(w - 1, 1) - 1.0f) * w / 2.0f;
        for (int64_t j = 0; j < l; ++j) {
            const float vy = (2.0f * j / std::max<int64_t>(l - 1, 1) - 1.0f) * l / 2.0f;
            for (int64_t k = 0; k < h; ++k) {
                const float vz =
                    (2.0f * k / std::max<int64_t>(h - 1, 1) - 1.0f) * h / 2.0f;
                // sample position = R(angle)*scale applied to lattice coords
                const float sx = ca * vx - sa * vy;
                const float sy = sa * vx + ca * vy;
                const float sz = scale * vz;
                // back to fractional indices (align_corners)
                const float fi = (sx / (w / 2.0f) + 1.0f) * 0.5f * (w - 1);
                const float fj = (sy / (l / 2.0f) + 1.0f) * 0.5f * (l - 1);
                const float fk = (sz / (h / 2.0f) + 1.0f) * 0.5f * (h - 1);
                float* d = dst + ((i * l + j) * h + k) * c;
                const float fs[3] = {fi, fj, fk};
                int64_t base[3];
                float frac[3];
                for (int a = 0; a < 3; ++a) {
                    base[a] = (int64_t)std::floor(fs[a]);
                    frac[a] = fs[a] - base[a];
                }
                for (int64_t ch = 0; ch < c; ++ch) d[ch] = 0.0f;
                for (int dx = 0; dx < 2; ++dx)
                    for (int dy = 0; dy < 2; ++dy)
                        for (int dz = 0; dz < 2; ++dz) {
                            const int64_t ii = base[0] + dx, jj = base[1] + dy,
                                          kk = base[2] + dz;
                            if (ii < 0 || ii >= dims[0] || jj < 0 ||
                                jj >= dims[1] || kk < 0 || kk >= dims[2])
                                continue;
                            const float wgt = (dx ? frac[0] : 1 - frac[0]) *
                                              (dy ? frac[1] : 1 - frac[1]) *
                                              (dz ? frac[2] : 1 - frac[2]);
                            const float* s =
                                src + ((ii * l + jj) * h + kk) * c;
                            for (int64_t ch = 0; ch < c; ++ch)
                                d[ch] += wgt * s[ch];
                        }
            }
        }
    }
}

// Fused pad-to-cube + patchify for the patch-major input fast path: one
// memory pass emits the [t, t, t, p^3, c] layout the dense patch embed
// consumes (see ops/patchify.patchify_np and the layout note in
// config.MAEConfig), skipping both the intermediate padded cube and the
// numpy 8-D transpose. t = r / p; src is (w, l, h, c); out-of-scene
// voxels are zero.
void pad_to_patches(const float* src, int64_t w, int64_t l, int64_t h,
                    int64_t c, float* dst, int64_t r, int64_t p) {
    const int64_t t = r / p;
    const int64_t cw = std::min(w, r), cl = std::min(l, r), ch = std::min(h, r);
    std::memset(dst, 0, sizeof(float) * t * t * t * p * p * p * c);
    for (int64_t i = 0; i < cw; ++i) {
        const int64_t ti = i / p, pi = i % p;
        for (int64_t j = 0; j < cl; ++j) {
            const int64_t tj = j / p, pj = j % p;
            const float* s = src + ((i * l + j) * h) * c;
            // dst patch row base for (ti, tj, *, (pi*p+pj)*p + *, *)
            float* drow = dst + (((ti * t + tj) * t) * p * p * p +
                                 (pi * p + pj) * p) * c;
            // the (k, c) src run maps to contiguous (pk, c) runs per tk
            for (int64_t tk = 0; tk * p < ch; ++tk) {
                const int64_t n = std::min<int64_t>(p, ch - tk * p);
                std::memcpy(drow + tk * p * p * p * c, s + tk * p * c,
                            sizeof(float) * n * c);
            }
        }
    }
}

}  // extern "C"
